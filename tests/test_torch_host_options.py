"""The conversion pipeline's options that needed OpenCV, against the JAX
package on seeded frames with tolerance 0: ``_detect_frame_morph`` under
each of the six host detection options (blobs' lines and pixels),
``preprocess_video_frame`` under ``cam_undistort`` (the maps and the
frames, grey and colour), ``VideoSource`` over PNG and BMP directories
(grey and colour reads), and ROADMAP C12 pinned as both packages have it:
``detect_engine=device`` ignores four options the host path applies."""
import cv2
import numpy as np
import pytest

from trex_tpu import pipeline as jax_pipeline
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.io.video import VideoSource as JaxVideoSource
from trex_tpu_torch import pipeline
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io.video import VideoSource

BASE = dict(detect_threshold=15, detect_threshold_is_absolute=False,
            track_threshold=20, track_background_subtraction=True,
            track_threshold_is_absolute=False, cm_per_pixel=1.0)
# each option as a user sets it; enable_difference=false thresholds the
# raw grey values, above the background's 200
OPTIONS = {
    "use_closing": dict(use_closing=True, closing_size=3),
    "use_closing_even": dict(use_closing=True, closing_size=4),
    "dilation_size": dict(dilation_size=2),
    "erosion": dict(dilation_size=-3),
    "blur_difference": dict(blur_difference=True),
    "use_adaptive_threshold": dict(use_adaptive_threshold=True,
                                   adaptive_threshold_scale=2.0),
    "enable_difference": dict(enable_difference=False, detect_threshold=170),
    "image_square_brightness": dict(image_square_brightness=True),
}


def _both(values):
    s, js = reset_global_settings(), jax_reset()
    for k, v in values.items():
        s.set(k, v)
        js.set(k, v)
    return s, js


def _scene(seed, h=96, w=128, n=8, stamps=4):
    """C12's input: `n` frames with `stamps` dark 7x12 stamps (their
    darkness drawn from the seed) and +-6 integer noise on a 200
    background; each frame adds a faint 1-px line, which the blur of
    ``blur_difference`` removes, and a dumbbell (two dark squares joined
    by a faint 3-px bridge), which the adaptive threshold cuts in two."""
    rng = np.random.default_rng(seed)
    bg = np.full((h, w), 200, np.uint8)
    pos = rng.uniform(10, [w - 24, 40], (stamps, 2))
    dark = rng.integers(18, 110, stamps)
    frames = []
    for f in range(n):
        img = bg.astype(np.int16) + rng.integers(-6, 7, (h, w))
        for k, (x, y) in enumerate(pos + f * np.array([2.0, 1.0])):
            xi, yi = int(x) % (w - 14), int(y) % 45
            img[yi:yi + 7, xi:xi + 12] = 200 - dark[k]
        x0 = 10 + 3 * f
        img[80, x0:x0 + 12] = 180
        img[60:67, x0 + 40:x0 + 47] = 100
        img[60:67, x0 + 53:x0 + 60] = 100
        img[62:65, x0 + 47:x0 + 53] = 180
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return bg, frames


def _blobs(blobs):
    return [(np.asarray(b.lines).tobytes(), np.asarray(b.pixels).tobytes())
            for b in blobs]


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_detect_frame_morph_equals_jax(option):
    s, js = _both(dict(BASE, **OPTIONS[option]))
    for seed in range(3):
        bg, frames = _scene(seed, n=3)
        frames.append(np.full_like(bg, 200))
        for img in frames:
            got = pipeline._detect_frame_morph(img, bg, s)
            want = jax_pipeline._detect_frame_morph(img, bg, js)
            assert _blobs(got) == _blobs(want)
            assert _blobs(pipeline.detect_frame(img, bg, s)) == _blobs(got)


def test_adaptive_threshold_at_a_wide_frame_equals_jax():
    """The block the pipeline picks at 1024 px (129), on a frame whose
    width leaves vector tails."""
    s, js = _both(dict(BASE, use_adaptive_threshold=True))
    bg, frames = _scene(7, h=1024, w=1031, n=1, stamps=12)
    got = pipeline._detect_frame_morph(frames[0], bg, s)
    want = jax_pipeline._detect_frame_morph(frames[0], bg, js)
    assert got and _blobs(got) == _blobs(want)


@pytest.mark.parametrize("terms", [4, 5, 8, 12, 14])
def test_undistortion_equals_jax(terms):
    rng = np.random.default_rng(terms)
    dist = list(rng.uniform(-0.2, 0.2, terms)
                * np.array([1, 1, 0.01, 0.01] + [1] * (terms - 4)))
    if terms == 14:
        dist[12:] = [0.01, -0.02]
    values = dict(cam_undistort=True, cam_matrix=[180.0, 0, 61.5, 0, 175.0,
                                                  47.0, 0, 0, 1],
                  cam_undistort_vector=dist)
    s, js = _both(values)
    maps = pipeline.build_undistort_maps(s, (123, 97))
    jmaps = jax_pipeline.build_undistort_maps(js, (123, 97))
    for a, b in zip(maps, jmaps):
        np.testing.assert_array_equal(a, b)
    for c in (0, 3):
        shape = (97, 123, c) if c else (97, 123)
        img = rng.integers(0, 256, shape, np.uint8)
        np.testing.assert_array_equal(
            pipeline.preprocess_video_frame(img, s, maps),
            jax_pipeline.preprocess_video_frame(img, js, jmaps))


@pytest.mark.parametrize("ext", ["png", "bmp"])
def test_video_source_over_image_files_equals_jax(tmp_path, ext):
    rng = np.random.default_rng(5)
    for i in range(4):
        shape = (37, 45, 3) if i % 2 else (37, 45)
        cv2.imwrite(str(tmp_path / f"f_{i:03d}.{ext}"),
                    rng.integers(0, 256, shape, np.uint8))
    for color in (False, True):
        for src in (str(tmp_path / f"f_%03d.{ext}"), str(tmp_path)):
            got, want = VideoSource(src, color), JaxVideoSource(src, color)
            assert len(got) == len(want) == 4
            for i in range(4):
                np.testing.assert_array_equal(got.get(i), want.get(i))


C12 = {"blur_difference": dict(blur_difference=True),
       "use_adaptive_threshold": dict(use_adaptive_threshold=True),
       "image_square_brightness": dict(image_square_brightness=True),
       "enable_difference": dict(enable_difference=False,
                                 detect_threshold=170)}


@pytest.mark.parametrize("option", sorted(C12))
def test_c12_device_detection_ignores_the_option(option):
    """ROADMAP C12, pinned, not fixed: under each of these four options
    the DeviceDetector returns the default path's blobs while the host
    applies the option, so their counts differ in both packages; the
    port equals the JAX package on both paths."""
    s, js = _both(dict(BASE, **C12[option]))
    bg, frames = _scene(1)
    host = [pipeline.detect_frame(f, bg, s) for f in frames]
    jhost = [jax_pipeline.detect_frame(f, bg, js) for f in frames]
    dev = pipeline.DeviceDetector(s, bg, device="cpu").detect(frames)
    jdev = jax_pipeline.DeviceDetector(js, bg).detect(frames)
    for a, b in zip(host, jhost):
        assert _blobs(a) == _blobs(b)
    for a, b in zip(dev, jdev):
        assert _blobs(a) == _blobs(b)
    n_host = sum(len(b) for b in host)
    n_dev = sum(len(b) for b in dev)
    assert n_host != n_dev, (option, n_host, n_dev)
