"""Posture closing without OpenCV: the port's ``close_mask`` and
``biggest_component(closing_steps=n)`` against ``cv2.dilate`` then
``cv2.erode`` (the JAX package's ``biggest_component``). Masks are
bit-equal (tolerance 0) for closing steps 1-3 and sizes 1-4 (the
default size 2 is even: the kernel's anchor sits at size // 2), on
random and hypothesis-drawn masks that touch the crop's edge, and the
whole per-blob posture with closing equals the JAX package's."""
import cv2
import numpy as np
import pytest
from hypothesis import given, settings as hsettings, strategies as st

from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.track import posture as jax_posture
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.track import posture
from trex_tpu_torch.track.blob import TrackBlob


def cv2_close(m, steps, size):
    k = np.ones((size, size), np.uint8)
    return cv2.erode(cv2.dilate(m, k, iterations=steps), k,
                     iterations=steps)


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_close_mask_equals_cv2_on_random_masks(steps, size):
    rng = np.random.default_rng(steps * 10 + size)
    for _ in range(200):
        h, w = rng.integers(1, 24, 2)
        m = (rng.random((h, w)) < rng.uniform(0.05, 0.95)).astype(np.uint8)
        np.testing.assert_array_equal(posture.close_mask(m, steps, size),
                                      cv2_close(m, steps, size))


@st.composite
def edge_masks(draw):
    """Masks whose set pixels include the crop's border rows and
    columns."""
    h = draw(st.integers(1, 16))
    w = draw(st.integers(1, 16))
    bits = draw(st.lists(st.booleans(), min_size=h * w, max_size=h * w))
    m = np.array(bits, np.uint8).reshape(h, w)
    edge = draw(st.sampled_from(["top", "bottom", "left", "right", "all"]))
    if edge in ("top", "all"):
        m[0, :] |= np.array(draw(st.lists(st.booleans(), min_size=w,
                                          max_size=w)), np.uint8)
    if edge in ("bottom", "all"):
        m[-1, :] = 1
    if edge in ("left", "all"):
        m[:, 0] = 1
    if edge == "right":
        m[:, -1] = 1
    return m


@hsettings(max_examples=300, deadline=None)
@given(edge_masks(), st.integers(1, 3), st.integers(2, 3))
def test_close_mask_equals_cv2_at_the_crop_edge(m, steps, size):
    np.testing.assert_array_equal(posture.close_mask(m, steps, size),
                                  cv2_close(m, steps, size))


def _blob_pair(rng, h=18, w=26):
    """A ragged blob with holes and a one-pixel neck, touching its
    bounding box on every side."""
    m = (rng.random((h, w)) < 0.75).astype(np.uint8)
    m[0, :] = m[-1, :] = 1
    m[:, 0] = 1
    m[h // 2, w // 2:] = 1
    m[:, w // 2] = 0
    m[h // 2, w // 2] = 1
    rows = []
    for y in range(h):
        xs = np.flatnonzero(m[y])
        if not len(xs):
            continue
        splits = np.flatnonzero(np.diff(xs) > 1)
        for s, e in zip(np.r_[0, splits + 1], np.r_[splits, len(xs) - 1]):
            rows.append((40 + y, 30 + xs[s], 30 + xs[e]))
    lines = np.array(rows, np.int32)
    n = int((lines[:, 2] - lines[:, 1] + 1).sum())
    px = rng.integers(40, 190, n).astype(np.uint8)
    return JaxTrackBlob(lines, px), TrackBlob(lines, px)


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("size", [2, 3])
def test_biggest_component_equals_jax(steps, size):
    rng = np.random.default_rng(steps * 7 + size)
    js = jax_reset()
    ps = reset_global_settings()
    bg = np.full((128, 128), 200, np.uint8)
    for trial in range(20):
        jb, pb = _blob_pair(rng)
        for thr in (0, 30, 90):
            ref, roff = jax_posture.biggest_component(
                jb, thr, bg, js, closing_steps=steps, closing_size=size)
            got, goff = posture.biggest_component(
                pb, thr, bg, ps, closing_steps=steps, closing_size=size)
            assert roff == goff
            assert (ref is None) == (got is None)
            if ref is not None:
                assert ref.dtype == got.dtype
                np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("steps", [1, 2])
def test_calculate_posture_with_closing_equals_jax(steps):
    rng = np.random.default_rng(steps)
    values = dict(posture_closing_steps=steps, posture_closing_size=2,
                  outline_resample=0.5, track_posture_threshold=20)
    js, ps = jax_reset(), reset_global_settings()
    for k, v in values.items():
        js.set(k, v)
        ps.set(k, v)
    bg = np.full((128, 128), 200, np.uint8)
    n = 0
    for _ in range(6):
        jb, pb = _blob_pair(rng, h=10, w=30)
        ref = jax_posture.calculate_posture(jb, js, bg)
        got = posture.calculate_posture(pb, ps, bg)
        assert (ref is None) == (got is None)
        if ref is None:
            continue
        assert ref.offset == got.offset
        np.testing.assert_array_equal(got.outline, ref.outline)
        assert (ref.midline is None) == (got.midline is None)
        if ref.midline is not None:
            n += 1
            np.testing.assert_array_equal(got.midline.segments,
                                          ref.midline.segments)
            assert got.midline.len == ref.midline.len
            assert got.midline.angle == ref.midline.angle
    assert n > 0
