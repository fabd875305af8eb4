"""Conversion + tracking pipelines.

Re-creates the reference's two engines:

- Segmenter (ui/Segmenter.{h,cpp}): convert task — video frames ->
  detection -> pv file + live tracking. The reference runs three
  ManagedThread stages (generate / serialize / track) with a capacity-10
  queue; here the same stages run as a decode+detect worker pool feeding
  an in-order serializer+tracker (host side is IO/CC-bound; the device
  path batches inside the detector).
- TrackingState (ui/TrackingState.cpp): track task — read pv frames,
  preprocess (threshold+prefilter) in a pool, serialized Tracker::add.

Counterpart of ``trex_tpu/pipeline.py``. Detection runs on the card
through `DeviceDetector` (detect_engine=device) and tracking through
the DeviceTracker (track_engine=device, or auto on a card). The object
Tracker (track_engine=object, and auto for the configurations both fast
engines refuse, the registry's defaults among them) tracks on the host,
with the per-blob posture chain of `run_postures`. OpenCV is imported
only by the options that need it (undistortion, resizing, histogram
equalisation, morphology, colour sources, the luminance grid,
mask_path, the raw-movie writer, file decode).
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time as _time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from .config import Settings
from .io.pv import PVFile, PVFrame, PVHeader
from .io.video import AveragingAccumulator, VideoSource
from .ops.labeling import label_blobs
from .track.blob import TrackBlob
from .track.individual import PostureStuff
from .track.motion import MotionRecord
from .track.posture import (calculate_posture,
                            calculate_posture_from_outline,
                            calculate_posture_from_pose)
from .track.tag_image import bgr_to_gray, resize_linear
from .track.tracker import Tracker
from .utils.timing import global_collector as _global_collector

_collector = _global_collector()

def _accelerator_healthy(device) -> bool:
    """True when CUDA is available and one tiny compute on `device`
    comes back to the host with the right value."""
    import torch

    if not torch.cuda.is_available():
        return False
    x = torch.ones((64, 64), device=device)
    return float((x @ x)[0, 0].cpu()) == 64.0


def select_tracker(settings: Settings, background,
                   need_individuals: bool = True,
                   gray_pixels: bool = True, device=None):
    """Pick the tracking engine per the `track_engine` setting.

    need_individuals=True turns on the engines' archive mode
    (track/archive.py), so the full product export surface
    (CSV/NPZ/posture/.results) works behind FastTracker and
    DeviceTracker. 'object' is the object Tracker (host). 'device' runs
    the DeviceTracker on `device` (``None`` = the card; ``"cpu"`` = its
    plain path). 'auto' picks the DeviceTracker on a healthy card and
    the host FastTracker when the caller named the CPU; with neither a
    card nor ``device="cpu"`` it raises, and a card that fails the test
    compute raises. Where that engine's ``check_supported`` /
    ``check_device_supported`` refuses the settings (the registry's
    defaults ``track_threshold 0`` and ``track_background_subtraction
    false`` among them), or the blob pixels are not gray, 'auto' picks
    the object Tracker, as the JAX package does; both fast engines
    refuse the same settings. The choice is made from the settings,
    before any frame, and the returned tracker's ``engine_choice`` says
    which engine was chosen and which refusal it answers. The object
    Tracker runs the tag network (``tags_recognize``) on `device`.
    """
    from .device import resolve_device
    from .track.device_engine import DeviceTracker, check_device_supported
    from .track.engine import EngineUnsupported, FastTracker, \
        check_supported

    mode = settings.get("track_engine", "auto") or "auto"
    if mode == "object":
        return _chosen(Tracker(settings, background=background,
                               device=device),
                       "track_engine=object: object Tracker (host)")
    if mode in ("fast", "device"):
        if not gray_pixels:
            raise EngineUnsupported("non-gray blob pixels")
        if mode == "device":
            tr = DeviceTracker(settings, background,
                               keep_individuals=need_individuals,
                               device=device)
            return _chosen(tr, f"track_engine=device: DeviceTracker "
                               f"({tr.device})")
        return _chosen(FastTracker(settings, background,
                                   keep_individuals=need_individuals),
                       "track_engine=fast: FastTracker (host)")
    if mode != "auto":
        raise ValueError(f"unknown track_engine {mode!r}")
    # auto: the device engine on a healthy card, the host FastTracker
    # only when the caller asked for the CPU, the object Tracker for the
    # settings both refuse
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card and not _accelerator_healthy(dev):
        raise RuntimeError(
            f"track_engine=auto: the CUDA device {dev} did not "
            "answer a test compute")
    engine = "DeviceTracker" if on_card else "FastTracker"
    try:
        if not gray_pixels:
            raise EngineUnsupported("non-gray blob pixels")
        check_supported(settings)
        if on_card:
            check_device_supported(settings)
    except EngineUnsupported as e:
        return _chosen(Tracker(settings, background=background,
                               device=dev),
                       f"track_engine=auto: object Tracker (host), "
                       f"{engine} refuses {e}")
    if on_card:
        return _chosen(DeviceTracker(settings, background,
                                     keep_individuals=need_individuals,
                                     device=dev),
                       f"track_engine=auto: DeviceTracker ({dev})")
    return _chosen(FastTracker(settings, background,
                               keep_individuals=need_individuals),
                   "track_engine=auto: FastTracker (host, device=cpu)")


def _chosen(tracker, note: str):
    tracker.engine_choice = note
    return tracker


def _posture_pool(tracker, settings: Settings, workers: int):
    """The thread pool of `run_postures` when the object Tracker computes
    postures (the fast engines compute their own); a null context
    otherwise."""
    if isinstance(tracker, Tracker) and settings["calculate_posture"]:
        return cf.ThreadPoolExecutor(max_workers=workers)
    return contextlib.nullcontext()


def generate_average(source: VideoSource, settings: Settings,
                     undistort_maps=None, color: bool = False) -> np.ndarray:
    """Background average over `average_samples` evenly spaced frames
    using `averaging_method` (Segmenter::trigger_average_generator +
    commons AveragingAccumulator). Frames get the same acquisition
    preprocessing as the conversion path."""
    n = min(int(settings["average_samples"]), len(source))
    acc = AveragingAccumulator(settings["averaging_method"])
    # sample indices round to nearest (matches the reference's frame
    # selection — truncation shifts samples and flips borderline
    # background pixels against the golden fixtures)
    for i in np.round(np.linspace(0, len(source) - 1, max(1, n))).astype(int):
        img = source.get(int(i))
        if img.ndim == 3 and not color:
            img = bgr_to_gray(img)
        acc.add(preprocess_video_frame(img, settings, undistort_maps))
    return acc.finalize()


def preprocess_video_frame(image: np.ndarray, settings: Settings,
                           undistort_maps=None) -> np.ndarray:
    """Acquisition-side preprocessing (AbstractBaseVideoSource::next(),
    core/AbstractVideoSource.h:172-287): undistortion from
    cam_matrix/cam_undistort_vector, meta_video_scale resize,
    crop_offsets, image_invert/image_adjust and equalize_histogram.
    OpenCV is imported only by the options that need it."""
    s = settings
    if undistort_maps is not None:
        import cv2

        image = cv2.remap(image, undistort_maps[0], undistort_maps[1],
                          cv2.INTER_LINEAR)
    scale = float(s["meta_video_scale"] or 0) \
        if "meta_video_scale" in s else 0.0
    if scale and scale > 0 and scale != 1.0:
        import cv2

        image = cv2.resize(image, None, fx=scale, fy=scale,
                           interpolation=cv2.INTER_AREA)
    crop = s["crop_offsets"]
    if crop and any(crop):
        h, w = image.shape[:2]
        l, t, r, b = [float(x) for x in crop]
        # fractions of the frame (commons CropOffsets)
        image = image[int(t * h) : h - int(b * h),
                      int(l * w) : w - int(r * w)]
    if s["image_invert"]:
        image = 255 - image
    if s["image_adjust"]:
        img = image.astype(np.float32) * float(s["image_contrast_increase"]) \
            + float(s["image_brightness_increase"])
        image = np.clip(img, 0, 255).astype(np.uint8)
    if s["equalize_histogram"] and image.ndim == 2:
        import cv2

        image = cv2.equalizeHist(image)
    return image


def build_undistort_maps(settings: Settings, size):
    """Precompute remap tables from cam_matrix/cam_undistort_vector."""
    s = settings
    mat = s["cam_matrix"]
    dist = s["cam_undistort_vector"]
    if not s["cam_undistort"] or not mat or not dist \
            or list(mat) == [1, 0, 0, 0, 1, 0, 0, 0, 1]:
        return None
    w, h = size
    import cv2

    K = np.asarray(mat, np.float64).reshape(3, 3)
    D = np.asarray(dist, np.float64)
    return cv2.initUndistortRectifyMap(K, D, None, K, (w, h), cv2.CV_32FC1)


def detect_frame(image: np.ndarray, background: np.ndarray,
                 settings: Settings) -> list[TrackBlob]:
    """background_subtraction detection for one frame
    (BackgroundSubtraction.cpp:126-347 + commons RawProcessing options):
    threshold vs background (with optional luminance correction and
    morphological closing/dilation), connected components,
    detect_size_filter in cm^2."""
    threshold = int(settings["detect_threshold"])
    absolute = bool(settings["detect_threshold_is_absolute"])
    if settings["use_closing"] or settings["dilation_size"] \
            or not settings["enable_difference"] \
            or settings["use_adaptive_threshold"] \
            or settings["blur_difference"] \
            or settings["image_square_brightness"]:
        return _detect_frame_morph(image, background, settings)
    # fuse the tracking-stage recount into the native labeling pass
    track_thr = int(settings["track_threshold"])
    track_abs = bool(settings["track_threshold_is_absolute"])
    use_bgsub = bool(settings["track_background_subtraction"])
    blobs = label_blobs(image, background, threshold=threshold,
                        absolute=absolute,
                        track_threshold=track_thr if use_bgsub else 0,
                        track_absolute=track_abs)
    cm = settings["cm_per_pixel"] or 1.0
    sq = cm * cm
    ranges = _detect_size_ranges(settings)
    out = []
    for b in blobs:
        size = b.num_pixels * sq
        if ranges and not any(lo <= size <= hi for lo, hi in ranges):
            continue
        tb = TrackBlob(b.lines, b.pixels, stats=b.stats)
        if b.stats is not None and track_thr > 0 and use_bgsub:
            tb._recount_cache[track_thr] = float(b.stats[1]) * sq
        out.append(tb)
    return out


def _detect_size_ranges(settings) -> list:
    """detect_size_filter, else the grabber-era blob_size_range when
    it was narrowed from its pass-all default."""
    ranges = settings["detect_size_filter"] or []
    if not ranges:
        bsr = settings["blob_size_range"]
        if bsr and not settings.is_default("blob_size_range"):
            ranges = [list(bsr)]
    return ranges


def _detect_frame_morph(image: np.ndarray, background: np.ndarray,
                        settings: Settings) -> list[TrackBlob]:
    """RawProcessing options path (grabber default_config.cpp:72-133
    docs; the commons implementation is absent from the snapshot so
    behavior follows the documented semantics): optional raw-greyscale
    thresholding (enable_difference=false), squared brightness,
    blur-then-rethreshold, adaptive thresholding, and morphological
    closing/dilation — then label the shapes with pixels from the
    original image."""
    import cv2

    s = settings
    threshold = int(s["detect_threshold"])
    absolute = bool(s["detect_threshold_is_absolute"])
    if not s["enable_difference"]:
        # threshold applies to the raw greyscale values
        diff = image.astype(np.int16)
    else:
        fi = image.astype(np.int16)
        bi = background.astype(np.int16)
        diff = np.abs(fi - bi) if absolute else bi - fi
    if s["image_square_brightness"]:
        # square the normalized difference: brightens bright, darkens
        # dark (doc) — thresholds then act on the squared scale
        dn = np.clip(diff, 0, 255).astype(np.float32) / 255.0
        diff = (dn * dn * 255.0).astype(np.int16)
    if s["blur_difference"]:
        # 1. truncate below threshold 2. blur 3. threshold again (doc)
        trunc = np.where(diff >= threshold, diff, 0).astype(np.uint8)
        blurred = cv2.GaussianBlur(trunc, (5, 5), 0)
        mask = ((blurred >= threshold) & (image > 0)).astype(np.uint8)
    elif s["use_adaptive_threshold"]:
        # per-neighborhood threshold on the difference image; the
        # scale param plays the C offset role (doc: 'threshold value
        # to be used for adaptive thresholding')
        d8 = np.clip(diff, 0, 255).astype(np.uint8)
        block = 2 * max(7, min(image.shape) // 16) + 1
        m = cv2.adaptiveThreshold(
            d8, 1, cv2.ADAPTIVE_THRESH_GAUSSIAN_C, cv2.THRESH_BINARY,
            block, -float(s["adaptive_threshold_scale"]))
        mask = (m.astype(bool) & (d8 >= threshold)
                & (image > 0)).astype(np.uint8)
    else:
        mask = ((diff >= threshold) & (image > 0)).astype(np.uint8)
    if s["use_closing"]:
        k = int(s["closing_size"])
        kernel = np.ones((k, k), np.uint8)
        mask = cv2.morphologyEx(mask, cv2.MORPH_CLOSE, kernel)
    d = int(s["dilation_size"])
    if d > 0:
        mask = cv2.dilate(mask, np.ones((d, d), np.uint8))
    elif d < 0:
        mask = cv2.erode(mask, np.ones((-d, -d), np.uint8))
    masked = np.where(mask > 0, np.maximum(image, 1), 0).astype(np.uint8)
    track_thr = int(s["track_threshold"])
    use_bgsub = bool(s["track_background_subtraction"])
    blobs = label_blobs(masked, background, threshold=0,
                        track_threshold=track_thr if use_bgsub else 0,
                        track_absolute=bool(s["track_threshold_is_absolute"]))
    cm = s["cm_per_pixel"] or 1.0
    sq = cm * cm
    ranges = _detect_size_ranges(s)
    out = []
    for b in blobs:
        size = b.num_pixels * sq
        if ranges and not any(lo <= size <= hi for lo, hi in ranges):
            continue
        tb = TrackBlob(b.lines, b.pixels, stats=b.stats)
        if b.stats is not None and track_thr > 0 and use_bgsub:
            tb._recount_cache[track_thr] = float(b.stats[1]) * sq
        out.append(tb)
    return out


class DeviceDetector:
    """detect_engine=device: batched background-subtraction detection
    on the card (ops/runcc run-based CC, the device counterpart of
    BackgroundSubtraction.cpp:126-347). A batch of frames goes through
    one `detect_batch_runs` call on `device` (``None`` = the card;
    ``"cpu"`` = its plain path); its tables are copied to the host
    before the call returns, so worker threads never share them.
    Outputs unpack to the same TrackBlob lists the host `detect_frame`
    produces — including the fused track-threshold recount — and any
    frame that overflows the capacity caps falls back to the host
    labeler, so results are engine-independent. `frames` and
    `overflow_frames` count the frames detected and those that fell
    back. One device only: the multi-device mesh is ROADMAP.md A
    item 4."""

    def __init__(self, settings: Settings, background: np.ndarray,
                 batch_size: Optional[int] = None, device=None):
        import threading

        import torch

        from .device import resolve_device

        s = settings
        self.settings = s
        self.background = background
        self.device = resolve_device(device)
        h, w = background.shape[:2]
        self.kw = dict(
            detect_threshold=int(s["detect_threshold"]),
            detect_absolute=bool(s["detect_threshold_is_absolute"]),
            track_threshold=int(s["track_threshold"])
            if s["track_background_subtraction"] else 0,
            track_absolute=bool(s["track_threshold_is_absolute"]),
            max_runs=4096, max_pixels=min(h * w, 1 << 17),
            max_blobs=1024, max_child_runs=4096, max_children=1024)
        self.batch_size = int(batch_size or s["detect_batch_size"] or 8)
        self._bg_dev = torch.as_tensor(np.ascontiguousarray(background),
                                       device=self.device)
        self._count_lock = threading.Lock()
        self.frames = 0
        self.overflow_frames = 0

    def detect(self, images: list[np.ndarray]) -> list[list[TrackBlob]]:
        import torch

        from .ops.runcc import detect_batch_runs

        n = len(images)
        B = self.batch_size
        pad = (-n) % B
        batch = np.stack(list(images) + [images[-1]] * pad)
        out = detect_batch_runs(torch.from_numpy(batch), self._bg_dev,
                                device=self.device, **self.kw)
        out = _to_host(out)
        with self._count_lock:
            self.frames += n
            self.overflow_frames += int(np.count_nonzero(
                out["overflow"][:n]))
        return [self._unpack(out, b, images[b]) for b in range(n)]

    def _unpack(self, out, b: int, image: np.ndarray) -> list[TrackBlob]:
        s = self.settings
        if bool(out["overflow"][b]):
            return detect_frame(image, self.background, s)
        det = out["det"]
        runs = out["det_runs"]
        max_blobs = self.kw["max_blobs"]
        y = runs["y"][b]
        valid = (y >= 0) & (runs["slot"][b] < max_blobs)
        y = y[valid].astype(np.int32)
        x0 = runs["x0"][b][valid].astype(np.int32)
        x1 = runs["x1"][b][valid].astype(np.int32)
        slot = runs["slot"][b][valid]
        order = np.lexsort((x0, y, slot))
        y, x0, x1, slot = y[order], x0[order], x1[order], slot[order]
        cm = s["cm_per_pixel"] or 1.0
        sq = cm * cm
        ranges = s["detect_size_filter"] or []
        track_thr = self.kw["track_threshold"]
        blobs = []
        starts = np.searchsorted(slot, np.arange(
            int(det["n_blobs"][b]) + 1))
        for i in range(int(det["n_blobs"][b])):
            size = float(det["count"][b, i]) * sq
            if ranges and not any(lo <= size <= hi for lo, hi in ranges):
                continue
            lo, hi = starts[i], starts[i + 1]
            lines = np.column_stack([y[lo:hi], x0[lo:hi], x1[lo:hi]])
            px = np.concatenate(
                [image[ly, lx0:lx1 + 1]
                 for ly, lx0, lx1 in lines]) if hi > lo \
                else np.zeros(0, np.uint8)
            tb = TrackBlob(np.ascontiguousarray(lines, np.int32), px)
            if track_thr > 0:
                tb._recount_cache[track_thr] = \
                    float(det["track_count"][b, i]) * sq
            blobs.append(tb)
        return blobs


def _to_host(tree):
    """A nested dict of tensors as numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def select_detector(settings: Settings, background: np.ndarray,
                    device=None):
    """Pick the detection engine per the `detect_engine` setting
    (None = per-frame host path); `device` is the DeviceDetector's."""
    mode = settings.get("detect_engine", "host") or "host"
    if mode == "device":
        if settings["use_closing"] or settings["dilation_size"]:
            raise ValueError(
                "detect_engine=device does not support morphology "
                "(use_closing/dilation_size) — use detect_engine=host")
        return DeviceDetector(settings, background, device=device)
    if mode != "host":
        raise ValueError(f"unknown detect_engine {mode!r}")
    return None


class LuminanceGrid:
    """Per-cell luminance correction (commons processing/LuminanceGrid):
    divides the arena into cells and normalizes each cell's brightness
    toward the global mean before thresholding (correct_luminance)."""

    def __init__(self, background: np.ndarray, cells: int = 32):
        if background.ndim == 3:  # luma drives the factors
            background = background.mean(axis=2)
        h, w = background.shape[:2]
        self.cells = cells
        ch = max(1, h // cells)
        cw = max(1, w // cells)
        grid = np.zeros((cells, cells), np.float32)
        for gy in range(cells):
            for gx in range(cells):
                region = background[gy * ch : (gy + 1) * ch,
                                    gx * cw : (gx + 1) * cw]
                grid[gy, gx] = region.mean() if region.size else 0.0
        target = float(background.mean())
        with np.errstate(divide="ignore", invalid="ignore"):
            factors = np.where(grid > 0, target / grid, 1.0)
        self.factor_map = resize_linear(factors.astype(np.float32), (w, h))

    def correct(self, image: np.ndarray) -> np.ndarray:
        f = self.factor_map if image.ndim == 2 \
            else self.factor_map[..., None]
        return np.clip(image.astype(np.float32) * f,
                       0, 255).astype(np.uint8)


class Segmenter:
    """Convert task: video -> detection -> .pv (+ tracking).

    `device` (``None`` = the card, ``"cpu"`` = the plain paths) is
    where detect_engine=device detects and track_engine=device/auto
    tracks."""

    def __init__(self, settings: Settings, source, output_path,
                 track: bool = True,
                 progress: Optional[Callable[[int, int], None]] = None,
                 workers: int = None, need_individuals: bool = True,
                 device=None):
        import os

        self.settings = settings
        self.device = device
        self.need_individuals = need_individuals
        # worker default scales with the host (floor 4: the pool also
        # hides IO latency on small machines)
        if workers is None:
            workers = min(8, max(4, os.cpu_count() or 4))
        # color encodings keep the source in color: detection still runs
        # on grayscale, stored blob pixels carry color (pv.cpp V_14
        # encodings rgb8 / r3g3b2)
        self._color = settings["meta_encoding"] in ("rgb8", "r3g3b2")
        self._source_desc = source if isinstance(source, str) \
            else type(source).__name__
        if isinstance(source, str) and source == "basler":
            # reference `source = basler` keyword (grabber default_config)
            from .io.video import BaslerVideoSource
            self.source = BaslerVideoSource(
                int(settings.get("basler_index", 0) or 0),
                color=self._color)
        elif isinstance(source, VideoSource):
            self.source = source
        elif isinstance(source, (str, Path)) \
                and str(source).endswith(".pv"):
            # pv re-read as a conversion source (core/PVVideoSource.h)
            from .io.video import PVVideoSource

            self.source = PVVideoSource(source)
        else:
            self.source = VideoSource(source, color=self._color)
        self.output_path = Path(output_path)
        self.terminate = False  # two-stage SIGINT sets this
        self.track = track
        self.progress = progress
        self.workers = workers
        self.background: Optional[np.ndarray] = None
        self.tracker = None
        self._closed_loop = None  # built lazily once the tracker exists
        self.detector: Optional[DeviceDetector] = None
        self.pv_file: Optional[PVFile] = None
        self.fps_stat = 0.0
        self._raw_writer = None  # save_raw_movie (core/tomp4 role)

    def _metadata(self) -> dict:
        s = self.settings
        keys = s["meta_write_these"] or []
        out = {}
        for k in keys:
            if k in s:
                try:
                    out[k] = s.format(k)
                except Exception:
                    pass
        return out

    def run(self, frame_range=None):
        s = self.settings
        src = self.source
        if not s["frame_rate"]:
            s.set("frame_rate", int(round(src.frame_rate)), source="video")
        if not s["meta_real_width"] and not s["cm_per_pixel"]:
            s.set("cm_per_pixel", 1.0, source="fallback")
        undistort_maps = build_undistort_maps(s, src.size)
        # video_size / video_source: informational facts about the
        # loaded source (grabber default_config) — recorded like the
        # meta_* params
        try:
            s.set("video_size", [float(src.size[0]),
                                 float(src.size[1])], source="video")
            s.set("video_source", str(self._source_desc),
                  source="video")
        except Exception:  # noqa: BLE001 - informational only
            pass
        # reset_average (grabber doc): regenerate from the live stream
        # even when the source carries a stored average (pv re-read)
        stored = getattr(src, "_bg", None)
        if stored is not None and not s["reset_average"] \
                and not self._color:
            average = np.asarray(stored)
        else:
            average = generate_average(src, s, undistort_maps,
                                       color=self._color)
        if average.ndim == 3:
            import cv2
            self.background = cv2.cvtColor(average, cv2.COLOR_BGR2GRAY)
            if s["meta_encoding"] == "r3g3b2":
                # r3g3b2 stores a 1-channel encoded average
                from .io.encoding import bgr_to_r3g3b2
                average = bgr_to_r3g3b2(average)
            elif s["meta_encoding"] == "rgb8":
                # pv stores RGB byte order (like the blob pixels)
                average = np.ascontiguousarray(average[..., ::-1])
        else:
            self.background = average
        w, h = src.size
        header = PVHeader(
            encoding=s["meta_encoding"],
            width=w, height=h,
            average=average,
            name=self.output_path.stem,
        )
        if frame_range is None:
            # video_conversion_range (grabber default_config.cpp:105,
            # applied like Segmenter::set_metadata): -1 keeps the
            # default on either side independently
            rng = s["video_conversion_range"] or [-1, -1]
            start = int(rng[0]) if rng[0] is not None and rng[0] >= 0 \
                else 0
            end = int(rng[1]) if len(rng) > 1 and rng[1] is not None \
                and rng[1] >= 0 else len(src) - 1
            frame_range = (start, end)
        header.conversion_start, header.conversion_end = frame_range

        if s["quit_after_average"]:
            # terminate directly after the background average
            # (grabber quit_after_average): write an empty-but-valid
            # pv carrying the average
            with PVFile.create(self.output_path, header) as pv:
                self.pv_file = pv
                pv.set_metadata(self._metadata())
            return None

        # correct_luminance (grabber default_config.cpp:128): even out
        # badly lit backgrounds — the stored average and every acquired
        # grayscale frame are corrected by the per-cell LuminanceGrid
        # before detection and pv write. (The tracker-side call site is
        # disabled in the reference snapshot; the grabber-side
        # acquisition correction is the documented behavior wired here.)
        lum_grid = None
        if s["correct_luminance"] and self.background is not None:
            lum_grid = LuminanceGrid(self.background)
            self.background = lum_grid.correct(self.background)
            if header.average is not None \
                    and s["meta_encoding"] in ("gray", "grey", "rgb8"):
                header.average = lum_grid.correct(header.average)

        # mask_path: a mask video/image multiplied onto every acquired
        # frame during conversion (RawProcessing mask multiply; 'only
        # works for conversions' per the grabber doc). Nonzero mask
        # pixels keep the frame, zero pixels blank it.
        conv_mask = None
        mask_p = str(s["mask_path"] or "").strip()
        if mask_p:
            try:
                msrc = VideoSource(mask_p)
                m = msrc.get(0)
                if m.ndim == 3:
                    import cv2

                    m = cv2.cvtColor(m, cv2.COLOR_BGR2GRAY)
                if m.shape != self.background.shape[:2]:
                    import cv2

                    m = cv2.resize(
                        m, (self.background.shape[1],
                            self.background.shape[0]),
                        interpolation=cv2.INTER_NEAREST)
                conv_mask = (m > 0)
                self.background = np.where(
                    conv_mask, self.background, 0).astype(np.uint8)
                if header.average is not None \
                        and header.average.ndim == 2:
                    header.average = self.background
                header.mask = conv_mask.astype(np.uint8)
            except Exception as e:  # noqa: BLE001 - bad mask: warn
                import sys as _sys

                print(f"[convert] cannot load mask_path {mask_p!r}: "
                      f"{e}", file=_sys.stderr)

        self.tracker = select_tracker(
            s, self.background, self.need_individuals,
            device=self.device) if self.track else None
        self.engine_choice = getattr(self.tracker, "engine_choice", None)
        device_det = self.detector = select_detector(
            s, self.background, device=self.device)
        frame_rate = float(s["frame_rate"] or 25)
        start_t = _time.perf_counter()
        n_frames = frame_range[1] - frame_range[0] + 1

        with PVFile.create(self.output_path, header) as pv, \
                _posture_pool(self.tracker, s, self.workers) as posture_pool:
            self.pv_file = pv
            pv.set_metadata(self._metadata())

            undistort = undistort_maps

            encoding = s["meta_encoding"]

            # color_channel: a fixed channel index replaces the BGR2GRAY
            # luma conversion (core/default_config color_channel doc)
            channel = s.get("color_channel", None)

            def load(idx):
                img = src.get(idx)
                color = None
                if img.ndim == 3:
                    import cv2

                    color = img if self._color else None
                    if channel is not None and 0 <= int(channel) < 3:
                        img = np.ascontiguousarray(img[..., int(channel)])
                    else:
                        img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
                img = preprocess_video_frame(img, s, undistort)
                if lum_grid is not None:
                    img = lum_grid.correct(img)
                if conv_mask is not None:
                    img = np.where(conv_mask, img, 0).astype(np.uint8)
                return img, color

            def produce(idx):
                with _collector.measure("decode+preprocess", idx):
                    img, color = load(idx)
                with _collector.measure("detect", idx):
                    blobs = detect_frame(img, self.background, s)
                attach_color(blobs, color)
                return idx, img, blobs

            def produce_batch(idxs):
                # detect_engine=device: one device call for the batch
                with _collector.measure("decode+preprocess", idxs[0]):
                    loaded = [load(i) for i in idxs]
                with _collector.measure("detect(device)", idxs[0]):
                    blob_lists = device_det.detect(
                        [im for im, _ in loaded])
                for (img, color), blobs in zip(loaded, blob_lists):
                    attach_color(blobs, color)
                return [(i, loaded[k][0], blob_lists[k])
                        for k, i in enumerate(idxs)]

            def attach_color(blobs, color):
                if color is not None:
                    # store color pixels under each mask (detection and
                    # tracking stay grayscale)
                    from .io.encoding import bgr_to_r3g3b2
                    color = preprocess_video_frame(color, s, undistort)
                    for b in blobs:
                        rows = [color[y, x0: x1 + 1]
                                for y, x0, x1 in b.lines]
                        px = np.concatenate(rows) if rows \
                            else np.zeros((0, 3), np.uint8)
                        if encoding == "r3g3b2":
                            b.store_pixels = bgr_to_r3g3b2(px)
                        else:  # rgb8: pv stores RGB byte order
                            b.store_pixels = px[:, ::-1].reshape(-1)

            with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
                next_submit = frame_range[0]
                next_write = frame_range[0]
                window = self.workers * 2 + 2  # backpressure cap
                futures = {}
                ready = {}  # device path: frames unpacked from batches
                step = device_det.batch_size if device_det else 1
                stop_minutes = int(s["stop_after_minutes"] or 0)
                while next_write <= frame_range[1]:
                    if stop_minutes and _time.perf_counter() - start_t \
                            > stop_minutes * 60:
                        # grabber stop_after_minutes: bounded recording
                        self.terminate = True
                    if self.terminate:
                        # graceful end: drop pending work, keep the pv
                        # readable (header update happens on close)
                        for f in futures.values():
                            f.cancel()
                        break
                    while (next_submit <= frame_range[1]
                           and len(futures) < window):
                        if device_det:
                            idxs = list(range(
                                next_submit,
                                min(next_submit + step,
                                    frame_range[1] + 1)))
                            futures[next_submit] = pool.submit(
                                produce_batch, idxs)
                            next_submit = idxs[-1] + 1
                        else:
                            futures[next_submit] = pool.submit(
                                produce, next_submit)
                            next_submit += 1
                    if device_det:
                        if next_write not in ready:
                            key = max(k for k in futures
                                      if k <= next_write)
                            for item in futures.pop(key).result():
                                ready[item[0]] = item
                        idx, img, blobs = ready.pop(next_write)
                    else:
                        idx, img, blobs = futures.pop(next_write).result()
                    virtual = idx - frame_range[0]
                    with _collector.measure("serialize", virtual):
                        fr = PVFrame(
                            timestamp=int(round(
                                (virtual + 1) * 1e6 / frame_rate)),
                            source_index=idx, index=virtual)
                        for b in blobs:
                            px = b.store_pixels \
                                if b.store_pixels is not None \
                                else b.pixels
                            fr.add_object(b.lines, px)
                        pv.add_frame(fr)
                    if s["save_raw_movie"]:
                        self._write_raw(img, frame_rate)
                    if self.tracker is not None:
                        with _collector.measure("track", virtual):
                            self._track_frame(virtual, blobs,
                                              virtual / frame_rate,
                                              posture_pool)
                    if self.progress:
                        self.progress(virtual + 1, n_frames)
                    next_write += 1
        if self._raw_writer is not None:
            self._raw_writer.release()
            self._raw_writer = None
        if hasattr(self.tracker, "finalize"):
            self.tracker.finalize()  # device engine: flush chunk buffer
        elapsed = _time.perf_counter() - start_t
        self.fps_stat = n_frames / elapsed if elapsed > 0 else 0.0
        return self.tracker

    def _write_raw(self, img: np.ndarray, frame_rate: float):
        """save_raw_movie: record the raw stream alongside conversion
        (core/tomp4.cpp / FFMPEGQueue). When `ffmpeg_path` is
        configured, frames pipe to that ffmpeg as rawvideo with
        libx264 at `ffmpeg_crf` (the reference's encoder settings);
        otherwise cv2.VideoWriter is the fallback encoder."""
        if self._raw_writer is None:
            # save_raw_movie_path overrides the default .mov beside
            # the pv (grabber default_config)
            override = str(self.settings["save_raw_movie_path"]
                           or "").strip()
            path = override if override \
                else str(self.output_path.with_suffix(".mov.mp4"))
            ffmpeg = str(self.settings["ffmpeg_path"] or "").strip()
            if ffmpeg and Path(ffmpeg).exists():
                import subprocess

                crf = int(self.settings["ffmpeg_crf"] or 23)
                pix = "bgr24" if img.ndim == 3 else "gray"
                proc = subprocess.Popen(
                    [ffmpeg, "-y", "-f", "rawvideo", "-pix_fmt", pix,
                     "-s", f"{img.shape[1]}x{img.shape[0]}",
                     "-r", str(frame_rate), "-i", "-",
                     "-c:v", "libx264", "-crf", str(crf),
                     "-pix_fmt", "yuv420p", path],
                    stdin=subprocess.PIPE,
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL)

                class _FFWriter:
                    def __init__(self, p):
                        self.p = p

                    def write(self, frame):
                        self.p.stdin.write(frame.tobytes())

                    def release(self):
                        self.p.stdin.close()
                        self.p.wait(timeout=300)

                self._raw_writer = _FFWriter(proc)
            else:
                import cv2

                fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                self._raw_writer = cv2.VideoWriter(
                    path, fourcc, frame_rate,
                    (img.shape[1], img.shape[0]), img.ndim == 3)
        self._raw_writer.write(img)

    def _track_frame(self, index: int, blobs, time: float,
                     posture_pool=None):
        tracker = self.tracker
        blobs = filter_blobs_by_prediction(blobs, self.settings)
        if not isinstance(tracker, Tracker):  # fast/device engines
            tracker.add_frame_blobs(index, time, blobs)
            return
        pp = tracker.preprocess_frame(index, blobs, time=time)
        tracker.add(pp)
        if posture_pool is not None:
            run_postures(tracker, index, self.settings, posture_pool)
        if self._closed_loop is None and \
                self.settings["closed_loop_enable"]:
            from .closed_loop import maybe_closed_loop

            self._closed_loop = maybe_closed_loop(tracker, self.settings,
                                                  device=self.device)
        if self._closed_loop is not None:
            self._closed_loop.update(index)


def filter_blobs_by_prediction(blobs: list, settings: Settings) -> list:
    """ML-label gates applied before the tracker sees the blobs
    (Tracker::preprocess label filters):

    - track_conf_threshold: drop detections whose class confidence is
      below the fraction,
    - track_only_classes: keep only the listed class ids/names,
    - track_only_segmentations: drop prediction-carrying blobs without
      a segmentation outline (avoids double-tracking bbox+mask).

    Blobs without predictions pass through unchanged."""
    s = settings
    conf = float(s["track_conf_threshold"] or 0)
    only = s["track_only_classes"] or []
    only_seg = bool(s["track_only_segmentations"])
    if conf <= 0 and not only and not only_seg:
        return blobs
    only_ids = {int(c) for c in only
                if isinstance(c, (int, float)) or str(c).isdigit()}
    only_names = {str(c) for c in only} - {str(i) for i in only_ids}
    names = s["detect_classes"] or {}
    out = []
    for b in blobs:
        pred = getattr(b, "prediction", None)
        if pred is None:
            out.append(b)
            continue
        p = pred.get("p") if isinstance(pred, dict) \
            else getattr(pred, "p", None)
        clid = pred.get("clid") if isinstance(pred, dict) \
            else getattr(pred, "clid", None)
        outline = pred.get("original_outline") if isinstance(pred, dict) \
            else getattr(pred, "original_outline", None)
        if conf > 0 and p is not None and p < conf:
            continue
        if (only_ids or only_names) and clid is not None:
            name = names.get(int(clid)) if isinstance(names, dict) \
                else None
            if int(clid) not in only_ids \
                    and (name is None or str(name) not in only_names):
                continue
        if only_seg and (outline is None or not len(outline)):
            continue
        out.append(b)
    return out


def run_postures(tracker: Tracker, frame: int, settings: Settings,
                 pool: Optional[cf.ThreadPoolExecutor] = None):
    """Posture per new assignment (TrackingHelper::process_postures):
    the posture of every individual assigned in `frame`, from its blob's
    pose keypoints, else its detection outline, else its pixels (the
    per-blob chain of `calculate_posture`). The frame's wall seconds go
    into its FrameStatistics' `posture_seconds`, which the JAX package
    leaves 0."""
    t0 = _time.perf_counter()
    jobs = []
    smoothing = int(settings["posture_direction_smoothing"] or 0)
    for ind in tracker.individuals.values():
        basic = ind.basic_stuff(frame)
        if basic is None or ind.posture_stuff(frame) is not None:
            continue
        direction = None
        if smoothing > 1:
            # posture_direction_smoothing: orientation votes averaged
            # over the last N posture frames (Individual::
            # calculate_previous_vector, Individual.cpp:2296-2349)
            direction = ind.calculate_previous_vector(frame, smoothing)
        else:
            prev = ind.posture[-1] if ind.posture else None
            if prev is not None and prev.midline is not None:
                d = prev.midline.midline_direction(
                    settings["midline_stiff_percentage"])
                direction = -d  # head-pointing
        jobs.append((ind, basic, direction))

    def work(job):
        ind, basic, direction = job
        # posture source precedence (TrackingHelper::process_postures):
        # pose skeleton > detection outline > pixels
        pred = getattr(basic.blob, "prediction", None) or {}
        kp = pred.get("keypoints") if isinstance(pred, dict) else None
        orig = pred.get("original_outline") \
            if isinstance(pred, dict) else None
        if kp is not None and len(np.asarray(kp).reshape(-1, 2)):
            res = calculate_posture_from_pose(
                basic.blob, np.asarray(kp, np.float64).reshape(-1, 2)[:, :2],
                settings, movement_direction=direction)
        elif orig is not None and len(orig):
            res = calculate_posture_from_outline(
                basic.blob, orig, settings, movement_direction=direction)
        else:
            res = calculate_posture(basic.blob, settings,
                                    tracker.background,
                                    movement_direction=direction)
        return ind, basic, res

    results = pool.map(work, jobs) if pool else map(work, jobs)
    cm = settings["cm_per_pixel"] or 1.0
    for ind, basic, res in results:
        if res is None:
            continue
        stuff = PostureStuff(frame=basic.frame)
        ox, oy = res.offset
        bx, by = basic.blob.bounds[:2]
        if res.outline is not None and len(res.outline):
            stuff.outline = res.outline + np.array([bx + ox, by + oy],
                                                   np.float32)
            stuff.outline_size = len(res.outline)
        if res.midline is not None:
            stuff.midline = res.midline
            # the midline's coordinate frame is the posture crop: keep
            # the crop offset with it (consumers add blob bounds + this)
            res.midline.offset = (float(ox), float(oy))
            stuff.midline_length = res.midline.len * cm
            stuff.midline_angle = res.midline.angle
            segs = res.midline.segments
            # head = the segment posture_head_percentage into the
            # (head-first) midline; posture centroid = the middle
            # segment (Individual.cpp:1459-1503 real_point indices)
            hp = settings["posture_head_percentage"]
            hi = min(len(segs) - 1, int(round(len(segs) * hp)))
            ci = min(len(segs) // 2, len(segs) - 1)
            off = np.array([bx + ox, by + oy])
            head_pt = segs[hi] + off
            cen_pt = segs[ci] + off
            prev_post = ind.posture[-1] if ind.posture else None
            stuff.head = MotionRecord.create(
                prev_post.head if prev_post else None,
                basic.centroid.time, float(head_pt[0]), float(head_pt[1]),
                res.midline.angle)
            stuff.centroid_posture = MotionRecord.create(
                prev_post.centroid_posture if prev_post else None,
                basic.centroid.time, float(cen_pt[0]), float(cen_pt[1]),
                res.midline.angle)
        ind.add_posture(stuff)
    st = tracker.statistics.get(frame)
    if st is not None:
        st.posture_seconds = _time.perf_counter() - t0


def batch_convert(settings, sources: list, output_dir, names=None,
                  track: bool = True, workers_per_video: int = 2,
                  device=None):
    """Multi-video batch ingest: convert several videos in one call
    (BASELINE config 5). Videos run sequentially on the host (decode/CC
    are CPU-bound here); detection/inference batches share the device.
    Returns [(pv_path, tracker)]."""
    from pathlib import Path

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for i, src in enumerate(sources):
        name = (names[i] if names and i < len(names)
                else Path(str(src).replace("%", "_")).stem or f"video{i}")
        pv_path = output_dir / f"{name}.pv"
        snap = settings.snapshot()
        try:
            seg = Segmenter(settings, src, pv_path, track=track,
                            workers=workers_per_video, device=device)
            tracker = seg.run()
            results.append((pv_path, tracker))
        finally:
            settings.restore(snap)
    return results


def auto_calculate_parameters(pv, settings, background,
                              quiet: bool = False):
    """auto_minmax_size / auto_number_individuals
    (Tracker::auto_calculate_parameters, Tracker.cpp:3508-3616): on
    videos longer than 1000 frames, sample ~500 frames, collect
    track-threshold blob sizes (cm^2); track_size_filter becomes
    [p25*0.25, p75*1.75] of the per-frame {p75, p90} size percentiles,
    and track_max_individuals the 95th percentile of per-frame counts
    passing that filter."""
    s = settings
    if len(pv) <= 1000 or not (s["auto_minmax_size"]
                               or s["auto_number_individuals"]):
        return
    from .track.prefilter import SizeFilters

    thr = int(s["track_threshold"])
    absolute = bool(s["track_threshold_is_absolute"])
    use_bgsub = bool(s["track_background_subtraction"])
    cm = s["cm_per_pixel"] or 1.0
    sq = cm * cm
    step = max(1, (len(pv) - len(pv) % 500) // 500)
    per_frame: list[np.ndarray] = []
    values: list[float] = []
    for i in range(0, len(pv), step):
        fr = pv.read_frame(i)
        sizes = []
        for k in range(fr.n):
            b = TrackBlob(fr.masks[k], fr.pixels[k])
            v = b.raw_recount(thr, background, absolute, use_bgsub) * sq
            if v > 0:
                sizes.append(v)
        arr = np.asarray(sizes)
        per_frame.append(arr)
        if len(arr):
            values += [float(np.percentile(arr, 75)),
                       float(np.percentile(arr, 90))]
    if not values:
        return
    lo, hi = np.percentile(np.asarray(values), [25, 75])
    if s["auto_minmax_size"]:
        s.set("track_size_filter", [[float(lo * 0.25),
                                     float(hi * 1.75)]],
              source="auto_minmax_size")
        if not quiet:
            print(f"[auto_minmax_size] track_size_filter = "
                  f"[[{lo * 0.25:.3f}, {hi * 1.75:.3f}]]")
    filt = SizeFilters(s["track_size_filter"])
    counts = [int(sum(1 for v in arr if filt.in_range_of_one(v)))
              for arr in per_frame]
    median_number = int(np.percentile(np.asarray(counts), 95))
    if median_number != int(s["track_max_individuals"]):
        if not quiet:
            print(f"[auto_calculate] detected {median_number} "
                  f"individuals/frame (set: "
                  f"{s['track_max_individuals']})")
        if s["auto_number_individuals"]:
            s.set("track_max_individuals", median_number,
                  source="auto_number_individuals")


class TrackingState:
    """Track task: re-track an existing .pv file
    (ui/TrackingState.cpp:176-264)."""

    def __init__(self, settings: Settings, pv_path,
                 progress: Optional[Callable[[int, int], None]] = None,
                 workers: int = None, need_individuals: bool = True,
                 device=None):
        import os

        self.settings = settings
        self.device = device
        if workers is None:
            workers = min(8, max(4, os.cpu_count() or 4))
        self.pv = PVFile.open(pv_path)
        self.progress = progress
        self.terminate = False  # two-stage SIGINT sets this
        self.workers = workers
        from .io.encoding import decode_background

        # rebuild the conversion-time grayscale background from the
        # stored average (RGB luma / r3g3b2 expansion for color pvs)
        self.background = decode_background(self.pv.header.average,
                                            self.pv.header.encoding)
        # apply pv metadata below explicit settings layers
        from .config import apply_dict

        meta = self.pv.header.metadata_dict()
        meta = {k: v for k, v in meta.items()
                if settings.source_of(k) in ("default", "pv-metadata")}
        apply_dict(settings, meta, source="pv-metadata")
        auto_calculate_parameters(self.pv, settings, self.background)
        self.tracker = select_tracker(
            settings, self.background, need_individuals,
            gray_pixels=self.pv.header.encoding in ("gray", "grey"),
            device=device)
        self.engine_choice = self.tracker.engine_choice

    def run(self, frame_range=None):
        s = self.settings
        n = len(self.pv)
        if frame_range is None:
            # analysis_range (default_config): [-1, -1] keeps the full
            # video; either side can be pinned independently
            rng = s["analysis_range"] or [-1, -1]
            lo = int(rng[0]) if rng[0] is not None and rng[0] >= 0 else 0
            hi = int(rng[1]) if len(rng) > 1 and rng[1] is not None \
                and 0 <= rng[1] < n else n - 1
            frame_range = (min(lo, n - 1), hi)
        frame_rate = float(s["frame_rate"] or 25)
        fast = not isinstance(self.tracker, Tracker)
        closed_loop = None
        if not fast:
            from .closed_loop import maybe_closed_loop

            closed_loop = maybe_closed_loop(self.tracker, s,
                                            device=self.device)
        enc = self.pv.header.encoding
        if enc in ("rgb8", "r3g3b2"):
            from .io.encoding import storage_to_gray

            def _px(raw):
                return storage_to_gray(raw, enc) if raw is not None \
                    else None
        else:
            def _px(raw):
                return raw

        def load(idx):
            t_load = _time.perf_counter()
            fr = self.pv.read_frame(idx)
            # tracking thresholds run on grayscale: decode stored color
            # pixel values (storage_to_gray) like the conversion did
            blobs = [TrackBlob(fr.masks[i], _px(fr.pixels[i]),
                               flags=fr.flags[i])
                     for i in range(fr.n)]
            # stored blob::Prediction records (class/pose/outlines)
            # feed the pose/outline posture paths on re-track
            for i, pr in enumerate(fr.predictions[:len(blobs)]):
                if pr is None:
                    continue
                blobs[i].prediction = {
                    "clid": int(pr.clid), "p": float(pr.p),
                    "keypoints": pr.pose,
                    "original_outline": pr.original_outline,
                }
            blobs = filter_blobs_by_prediction(blobs, s)
            # track_enforce_frame_rate (default true): kinematics use
            # the enforced frame clock, not the stored camera
            # timestamps (default_config doc)
            t = idx / frame_rate if s["track_enforce_frame_rate"] \
                else fr.timestamp / 1e6
            if fast:
                return idx, t, blobs
            pp = self.tracker.preprocess_frame(idx, blobs, time=t,
                                               timestamp=fr.timestamp)
            # reading and prefiltering the frame: the FrameStatistics'
            # loading_seconds, which the JAX package leaves 0
            return pp, _time.perf_counter() - t_load

        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool, \
                _posture_pool(self.tracker, s, self.workers) as posture_pool:
            futures = {}
            next_submit = frame_range[0]
            next_track = frame_range[0]
            window = self.workers * 2 + 2
            while next_track <= frame_range[1]:
                while s["track_pause"] and not self.terminate:
                    # track_pause halts the analysis until cleared
                    # (ui/TrackingState.cpp pause loop)
                    _time.sleep(0.05)
                if self.terminate:
                    for f in futures.values():
                        f.cancel()
                    break
                while (next_submit <= frame_range[1]
                       and len(futures) < window):
                    futures[next_submit] = pool.submit(load, next_submit)
                    next_submit += 1
                loaded = futures.pop(next_track).result()
                if fast:
                    self.tracker.add_frame_blobs(*loaded)
                else:
                    pp, load_s = loaded
                    self.tracker.add(pp)
                    self.tracker.statistics[pp.index].loading_seconds = \
                        load_s
                    if posture_pool is not None:
                        run_postures(self.tracker, next_track, s,
                                     posture_pool)
                    if closed_loop is not None:
                        closed_loop.update(next_track)
                if self.progress:
                    self.progress(next_track - frame_range[0] + 1,
                                  frame_range[1] - frame_range[0] + 1)
                next_track += 1
        if hasattr(self.tracker, "finalize"):
            self.tracker.finalize()  # device engine: flush chunk buffer
        return self.tracker
