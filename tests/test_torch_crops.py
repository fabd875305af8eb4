"""The port's identity crops (trex_tpu_torch/ops/crops.py) against the
JAX package's (trex_tpu/ops/crops.py, which warps with OpenCV).

`normalized_crop` is held bit for bit to the JAX function in every
normalization mode and in raw mode, and the port's own warp
(`warp_affine_u8`, native/warp.cpp) bit for bit to cv2.warpAffine over
hypothesis-drawn angles, scales, sub-pixel centres, output sizes and
crops past the image's edge. `warp_crops_device` (plain torch) is held
to the JAX program within 4e-3 grey levels: both map coordinates in
float32 (below 64 here, one ulp 2^-18) but may round cos, sin and the
products differently by a few ulps, and a pixel step of up to 255 turns
that into a few 1e-3 of a grey level."""
import math
from types import SimpleNamespace

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings as hsettings, strategies as st

from trex_tpu.ops import crops as jax_crops
from trex_tpu.track.blob import TrackBlob as JaxBlob
from trex_tpu_torch.ops import crops
from trex_tpu_torch.track.blob import TrackBlob

MODES = ["none", "moments", "posture", "legacy"]


def _blob_lines(mask):
    """(y, x0, x1) runs of a boolean mask, row by row."""
    lines = []
    for y in range(mask.shape[0]):
        row = np.concatenate([[0], mask[y].astype(np.int8), [0]])
        d = np.diff(row)
        for x0, x1 in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
            lines.append((y, x0, x1 - 1))
    return np.asarray(lines, np.int32).reshape(-1, 3)


def _scene(seed, size=96):
    """A background and a few elliptical blobs on it (some cut by the
    image's edge), as (jax blob, port blob) pairs."""
    rng = np.random.default_rng(seed)
    bg = rng.integers(150, 256, (size, size)).astype(np.uint8)
    img = bg.copy()
    yy, xx = np.mgrid[0:size, 0:size]
    out = []
    for k in range(6):
        cx, cy = rng.uniform(-4, size + 4, 2) if k < 2 \
            else rng.uniform(10, size - 10, 2)
        a, b = rng.uniform(3, 14), rng.uniform(2, 6)
        t = rng.uniform(-math.pi, math.pi)
        u = (xx - cx) * math.cos(t) + (yy - cy) * math.sin(t)
        v = -(xx - cx) * math.sin(t) + (yy - cy) * math.cos(t)
        m = (u / a) ** 2 + (v / b) ** 2 <= 1
        if m.sum() < 3:
            continue
        img[m] = rng.integers(0, 140, int(m.sum()))
        lines = _blob_lines(m)
        px = np.concatenate([img[y, x0:x1 + 1] for y, x0, x1 in lines])
        out.append((JaxBlob(lines, px), TrackBlob(lines, px)))
    return bg, out


@pytest.mark.parametrize("size", [(80, 80), (64, 48), (37, 50)])
@pytest.mark.parametrize("mode", MODES + ["raw"])
def test_normalized_crop_equals_jax(mode, size):
    """Every mode, with and without a midline, scale and median length,
    bit for bit; output widths with and without a partial vector step
    of OpenCV's loop."""
    for seed in range(4):
        bg, blobs = _scene(seed)
        rng = np.random.default_rng(100 + seed)
        s = {"individual_image_normalization":
             "posture" if mode == "raw" else mode,
             "individual_image_size": list(size),
             "individual_image_scale": float(rng.choice([1.0, 0.7, 1.6]))}
        for jb, pb in blobs:
            for midline in (None, SimpleNamespace(
                    angle=rng.uniform(-math.pi, math.pi),
                    len=rng.uniform(5, 30))):
                med = float(rng.uniform(5, 30)) if seed % 2 else None
                kw = dict(midline=midline, median_midline_length=med,
                          raw=mode == "raw")
                want = jax_crops.normalized_crop(jb, bg, s, **kw)
                got = crops.normalized_crop(pb, bg, s, **kw)
                assert got.dtype == np.uint8 and got.shape == want.shape
                assert np.array_equal(got, want), (seed, mode, size)
    want_d, off_d = jax_crops.diff_image(blobs[0][0], bg, pad=2)
    got_d, off_p = crops.diff_image(blobs[0][1], bg, pad=2)
    assert np.array_equal(got_d, want_d) and off_d == off_p


def test_rotation_matrix_equals_cv2():
    rng = np.random.default_rng(3)
    for _ in range(500):
        c = tuple(rng.uniform(-50, 150, 2))
        ang, sc = rng.uniform(-400, 400), rng.uniform(0.05, 5)
        assert np.array_equal(crops.rotation_matrix(c, ang, sc),
                              cv2.getRotationMatrix2D(c, ang, sc))


@st.composite
def warp_cases(draw):
    h = draw(st.integers(1, 48))
    w = draw(st.integers(1, 48))
    kind = draw(st.sampled_from(["random", "binary", "levels"]))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    if kind == "random":
        src = rng.integers(0, 256, (h, w)).astype(np.uint8)
    elif kind == "binary":
        src = (rng.integers(0, 2, (h, w)) * 255).astype(np.uint8)
    else:
        src = (rng.integers(0, 4, (h, w)) * 85).astype(np.uint8)
    # sub-pixel centres inside, on and past the image's edge
    cx = draw(st.floats(-6, w + 6, allow_nan=False))
    cy = draw(st.floats(-6, h + 6, allow_nan=False))
    angle = draw(st.one_of(
        st.floats(-720, 720, allow_nan=False),
        st.sampled_from([0.0, 90.0, -90.0, 180.0, 45.0, -135.0])))
    scale = draw(st.one_of(st.floats(0.1, 6.0, allow_nan=False),
                           st.just(1.0)))
    tw = draw(st.one_of(st.just(80), st.integers(1, 100)))
    th = draw(st.one_of(st.just(80), st.integers(1, 100)))
    return src, (cx, cy), angle, scale, (tw, th)


@hsettings(max_examples=400, deadline=None)
@given(warp_cases())
def test_warp_equals_cv2_warp_affine(case):
    src, (cx, cy), angle, scale, (tw, th) = case
    m = cv2.getRotationMatrix2D((cx, cy), angle, scale)
    m[0, 2] += tw / 2 - cx
    m[1, 2] += th / 2 - cy
    want = cv2.warpAffine(src, m, (tw, th), flags=cv2.INTER_LINEAR,
                          borderValue=0)
    got = crops.warp_affine_u8(src, m, (tw, th))
    assert np.array_equal(got, want)


def test_warp_crops_device_equals_jax():
    rng = np.random.default_rng(7)
    B, H, W = 6, 40, 56
    images = rng.uniform(0, 255, (B, H, W)).astype(np.float32)
    centers = np.stack([rng.uniform(5, W - 5, B),
                        rng.uniform(5, H - 5, B)], 1).astype(np.float32)
    angles = rng.uniform(-math.pi, math.pi, B).astype(np.float32)
    scales = rng.uniform(0.5, 2.0, B).astype(np.float32)
    for hw in ((80, 80), (24, 40)):
        want = np.asarray(jax_crops.warp_crops_device(
            jnp.asarray(images), jnp.asarray(centers), jnp.asarray(angles),
            jnp.asarray(scales), out_hw=hw))
        got = crops.warp_crops_device(
            torch.from_numpy(images), torch.from_numpy(centers),
            torch.from_numpy(angles), torch.from_numpy(scales), out_hw=hw)
        assert got.dtype == torch.float32 and got.shape == (B, *hw)
        got = got.numpy()
        assert np.array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
