"""Port parity: trex_tpu_torch.ops.runcc vs trex_tpu.ops.runcc on the CPU.

Inputs are made with numpy from fixed seeds and go through both
packages; every output table must be exactly equal, fill values
included."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trex_tpu.ops.device_pipeline import detect_batch as jax_detect_batch
from trex_tpu.ops.runcc import detect_batch_runs as jax_runs
from trex_tpu_torch.ops.device_pipeline import detect_batch
from trex_tpu_torch.ops.runcc import detect_batch_runs


def _random_frames(rng, B, H, W, n_stamps=30):
    bg = np.full((H, W), 200, np.uint8)
    frames = np.full((B, H, W), 200, np.uint8)
    for b in range(B):
        for _ in range(n_stamps):
            y = rng.integers(0, H - 10)
            x = rng.integers(0, W - 14)
            frames[b, y:y + rng.integers(2, 9),
                   x:x + rng.integers(2, 13)] = rng.integers(60, 160)
    return bg, frames


def synth_scene(n_frames, n_fish, size, seed=0):
    """The benchmark's synthetic scene at a small size: dark elongated
    blobs with per-fish asymmetric stamps, reflected at the walls."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(30, size - 30, (n_fish, 2))
    vel = rng.normal(0, 2.0, (n_fish, 2))
    stamps = []
    for i in range(n_fish):
        w = int(13 + (i % 5))
        h = int(8 + (i % 3))
        st = np.zeros((h, w), np.uint8)
        st[2:h - 2, 1:w - 1] = 90
        st[3:h - 3, 0:w] = 110
        st[2, w - 3:w - 1] = 0
        st[h - 3, 1:3] = 70
        stamps.append(st)
    bg = np.full((size, size), 200, np.uint8)
    frames = []
    for _ in range(n_frames):
        img = bg.copy()
        vel += rng.normal(0, 0.6, vel.shape)
        np.clip(vel, -4, 4, out=vel)
        pos += vel
        over = (pos < 20) | (pos > size - 25)
        vel[over] *= -1
        pos = np.clip(pos, 20, size - 25)
        for k, (x, y) in enumerate(pos):
            st = stamps[k]
            xi, yi = int(x), int(y)
            region = img[yi:yi + st.shape[0], xi:xi + st.shape[1]]
            np.minimum(region, 200 - st[:region.shape[0], :region.shape[1]],
                       out=region)
        frames.append(img)
    return bg, np.stack(frames)


def _assert_tree_equal(ref, got, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), (path, set(ref) ^ set(got))
        for k in ref:
            _assert_tree_equal(ref[k], got[k], f"{path}/{k}")
        return
    r = np.asarray(ref)
    g = got.cpu().numpy()
    assert r.shape == g.shape, (path, r.shape, g.shape)
    assert r.dtype == g.dtype, (path, r.dtype, g.dtype)
    np.testing.assert_array_equal(g, r, err_msg=path)


def _both(frames, bg, **kw):
    ref = jax.device_get(jax_runs(jnp.asarray(frames), jnp.asarray(bg),
                                  **kw))
    got = detect_batch_runs(frames, bg, device="cpu", **kw)
    return ref, got


CAPS = dict(max_runs=512, max_pixels=8192, max_blobs=128,
            max_child_runs=512, max_children=128)


@pytest.mark.parametrize("absolute", [False, True])
def test_runs_tables_equal_jax(absolute):
    rng = np.random.default_rng(7)
    bg, frames = _random_frames(rng, 4, 128, 160)
    ref, got = _both(frames, bg, detect_threshold=15,
                     detect_absolute=absolute, track_threshold=20,
                     track_absolute=absolute, **CAPS)
    assert not np.asarray(ref["overflow"]).any()
    _assert_tree_equal(ref, got)


def test_children_tables_equal_jax():
    rng = np.random.default_rng(11)
    bg, frames = _random_frames(rng, 2, 96, 128)
    ref, got = _both(frames, bg, detect_threshold=10,
                     detect_absolute=False, track_threshold=60,
                     track_absolute=False, **CAPS)
    _assert_tree_equal(ref, got)


def test_no_track_threshold_tables_equal_jax():
    rng = np.random.default_rng(3)
    bg, frames = _random_frames(rng, 2, 64, 96, n_stamps=12)
    ref, got = _both(frames, bg, detect_threshold=15,
                     detect_absolute=False, max_runs=256, max_pixels=4096,
                     max_blobs=64, max_child_runs=256, max_children=64)
    assert "child" not in got
    _assert_tree_equal(ref, got)


@pytest.mark.parametrize("caps", [
    dict(max_runs=16, max_pixels=64, max_blobs=8, max_child_runs=16,
         max_children=8),
    dict(max_runs=4096, max_pixels=64, max_blobs=8, max_child_runs=4096,
         max_children=8),
    dict(max_runs=4096, max_pixels=4096, max_blobs=8, max_child_runs=16,
         max_children=512),
])
def test_overflow_caps_equal_jax(caps):
    """Each cap on its own overflows a dense noise frame; every table
    (collapsed runs, truncated pixel lists, slot clamping) still equals
    the reference."""
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 255, (2, 64, 64)).astype(np.uint8)
    bg = np.full((64, 64), 200, np.uint8)
    ref, got = _both(frame, bg, detect_threshold=5, detect_absolute=True,
                     track_threshold=40, track_absolute=True, **caps)
    assert np.asarray(ref["overflow"]).all()
    _assert_tree_equal(ref, got)


def test_pixel_grid_and_runs_agree_slot_for_slot():
    """detect_batch (pixel-grid labels, plain labeler on the CPU) and
    detect_batch_runs give the same blobs in the same slot order on the
    synthetic scene, and the port's detect_batch equals the
    reference's."""
    bg, frames = synth_scene(3, 24, 160, seed=1)
    kw = dict(threshold=15, absolute=False, track_threshold=20,
              max_blobs=64)
    grid = detect_batch(frames, bg, use_pallas=True, device="cpu", **kw)
    ref = jax.device_get(jax_detect_batch(
        jnp.asarray(frames), jnp.asarray(bg), use_pallas=False, **kw))
    for k in ("cx", "cy", "count", "track_count", "valid"):
        np.testing.assert_array_equal(grid[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    runs = detect_batch_runs(frames, bg, detect_threshold=15,
                             detect_absolute=False, track_threshold=20,
                             track_absolute=False, max_runs=2048,
                             max_pixels=1 << 14, max_blobs=64,
                             max_child_runs=2048, max_children=64,
                             device="cpu")
    assert not runs["overflow"].any()
    d = runs["det"]
    for b in range(frames.shape[0]):
        n = int(d["n_blobs"][b])
        assert n > 0 and int(grid["valid"][b].sum()) == n
        np.testing.assert_array_equal(grid["count"][b, :n], d["count"][b, :n])
        np.testing.assert_array_equal(grid["track_count"][b, :n],
                                      d["track_count"][b, :n])
        cnt = d["count"][b, :n]
        np.testing.assert_array_equal(grid["cx"][b, :n], d["sum_x"][b, :n] / cnt)
        np.testing.assert_array_equal(grid["cy"][b, :n], d["sum_y"][b, :n] / cnt)


def test_entry_point_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    bg, frames = _random_frames(np.random.default_rng(0), 1, 32, 32, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_batch_runs(frames, bg, detect_threshold=15,
                          detect_absolute=False)
