"""The conversion pipeline's image operations without OpenCV
(trex_tpu_torch/pipeline.py), held to cv2 bit for bit under hypothesis:
``meta_video_scale``'s area resize by a factor (``cv2.resize(img, None,
fx, fy, INTER_AREA)``: the destination size rounded as OpenCV rounds
``fx * width``, the source step ``1 / fx``, OpenCV's integer-factor path
with the blocks the image's edge cuts), ``equalize_histogram``
(``cv2.equalizeHist``), a ``mask_path`` of another size
(``INTER_NEAREST``) and the BGR frames', averages' and masks' grey
conversion (``cvtColor(BGR2GRAY)``). Tolerance 0."""
import sys

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.pipeline import Segmenter, preprocess_video_frame
from trex_tpu_torch.track import tag_image as ti

FACTORS = st.one_of(st.sampled_from([0.5, 0.25, 1 / 3, 0.3, 0.75, 0.9,
                                     1.5, 2.0, 0.2, 0.125, 0.45]),
                    st.floats(0.05, 2.5))


def _image(h, w, seed, channels=0):
    shape = (h, w, channels) if channels else (h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _preprocess(img, **values):
    s = reset_global_settings()
    for k, v in values.items():
        s.set(k, v)
    return preprocess_video_frame(img, s)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 80), st.integers(1, 80), st.integers(0, 2 ** 32 - 1),
       FACTORS, st.sampled_from([0, 3]))
def test_meta_video_scale_equals_cv2(h, w, seed, f, channels):
    img = _image(h, w, seed, channels)
    try:
        want = cv2.resize(img, None, fx=f, fy=f,
                          interpolation=cv2.INTER_AREA)
    except cv2.error:  # an empty destination
        with pytest.raises(ValueError, match="empty"):
            _preprocess(img, meta_video_scale=f)
        return
    got = _preprocess(img, meta_video_scale=f)
    assert got.shape == want.shape and np.array_equal(got, want)


@settings(max_examples=300, deadline=None)
@given(st.integers(1, 60), st.integers(1, 60), st.integers(0, 2 ** 32 - 1),
       FACTORS, FACTORS)
def test_area_resize_by_two_factors_equals_cv2(h, w, seed, fx, fy):
    img = _image(h, w, seed)
    try:
        want = cv2.resize(img, None, fx=fx, fy=fy,
                          interpolation=cv2.INTER_AREA)
    except cv2.error:  # an empty destination
        with pytest.raises(ValueError, match="empty"):
            ti.resize_area(img, None, fx=fx, fy=fy)
        return
    got = ti.resize_area(img, None, fx=fx, fy=fy)
    assert got.shape == want.shape and np.array_equal(got, want)


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 80), st.integers(1, 80), st.integers(0, 2 ** 32 - 1),
       st.integers(1, 255))
def test_equalize_histogram_equals_cv2(h, w, seed, levels):
    img = (_image(h, w, seed).astype(np.int64) // (256 // levels)).astype(
        np.uint8)
    got = _preprocess(img, equalize_histogram=True)
    assert np.array_equal(got, cv2.equalizeHist(img))


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 80), st.integers(1, 80), st.integers(1, 120),
       st.integers(1, 120), st.integers(0, 2 ** 32 - 1))
def test_mask_resize_and_grey_conversion_equal_cv2(h, w, th, tw, seed):
    mask = _image(h, w, seed, 3)
    grey = ti.bgr_to_gray(mask)
    assert np.array_equal(grey, cv2.cvtColor(mask, cv2.COLOR_BGR2GRAY))
    assert np.array_equal(
        ti.resize_nearest(grey, (tw, th)),
        cv2.resize(grey, (tw, th), interpolation=cv2.INTER_NEAREST))


def test_segmenter_colour_video_and_mask_without_opencv(tmp_path,
                                                        monkeypatch):
    """A BGR source, a colour mask image of another size and the
    equalization: the Segmenter converts without calling cv2's grey
    conversion, resize or equalization from pipeline.py (the image file
    is still decoded by cv2), and its .pv holds what cv2's operations
    give. (``meta_video_scale`` is held above: the Segmenter of both
    packages writes the source's size into the .pv header beside a
    scaled average, which the writer refuses.)"""
    import chip_smoke
    from trex_tpu_torch.io.pv import PVFile

    rng = np.random.default_rng(3)
    frames = rng.integers(150, 256, (6, 48, 64, 3), np.uint8)
    for f in range(6):
        frames[f, 10:18, 8 + 4 * f:20 + 4 * f] = 30
    mask = np.zeros((30, 40, 3), np.uint8)
    mask[2:28, 3:37] = (10, 200, 90)
    cv2.imwrite(str(tmp_path / "mask.png"), mask)
    # the same operations through cv2, before they are taken away
    grey = [cv2.equalizeHist(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY))
            for f in frames]
    m = cv2.resize(cv2.imread(str(tmp_path / "mask.png"),
                              cv2.IMREAD_GRAYSCALE),
                   (grey[0].shape[1], grey[0].shape[0]),
                   interpolation=cv2.INTER_NEAREST) > 0

    def guarded(name):
        orig = getattr(cv2, name)

        def call(*a, **k):
            caller = sys._getframe(1).f_code.co_filename
            assert not caller.endswith("pipeline.py"), name
            return orig(*a, **k)
        return call
    for name in ("cvtColor", "resize", "equalizeHist"):
        monkeypatch.setattr(cv2, name, guarded(name))
    s = reset_global_settings()
    for k, v in dict(equalize_histogram=True, meta_encoding="gray",
                     mask_path=str(tmp_path / "mask.png"),
                     detect_threshold=40, frame_rate=25).items():
        s.set(k, v)
    out = tmp_path / "v.pv"
    Segmenter(s, chip_smoke.array_source(frames), out, track=False).run()
    with PVFile.open(out) as pv:
        assert (pv.header.width, pv.header.height) == (64, 48)
        np.testing.assert_array_equal(pv.header.mask.astype(bool), m)
        n_blobs = 0
        for i in range(len(frames)):
            fr = pv.read_frame(i)
            for lines, px in zip(fr.masks, fr.pixels):
                want = np.concatenate([grey[i][y, x0:x1 + 1]
                                       for y, x0, x1 in np.asarray(lines)])
                np.testing.assert_array_equal(np.asarray(px), want)
                n_blobs += 1
        assert n_blobs >= len(frames)
