"""Port parity: the port's host FastTracker (base configuration) against
the JAX package's FastTracker on the CPU, frame by frame.

Tolerance: fish ids, blob counts and tracklet bookkeeping exactly equal;
x, y and probabilities within 1e-6 (both engines compute them in
float64 numpy from the same labeler output, so they agree to the last
bit in practice).

The scenes are shared with the DeviceTracker twin tests."""
import numpy as np
import pytest

from trex_tpu.config import reset_global_settings
from trex_tpu.ops.labeling import label_blobs_raw as jax_label_blobs_raw
from trex_tpu.track.engine import FastTracker as JaxFastTracker
from trex_tpu_torch.config import DEFAULTS
from trex_tpu_torch.ops.labeling import label_blobs_raw
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.engine import (EngineUnsupported, FastTracker,
                                         check_supported)
from trex_tpu_torch.ops.labeling import label_blobs

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread per test process while a port module runs: the
    workers of a parallel run share the cores, and the port's CPU ops on
    these small scenes gain nothing from more threads, which would only
    spin against the other workers'."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def settings(n_fish, **over):
    """The JAX package's settings of tests/test_device_engine.py in the
    base configuration, with overrides."""
    s = reset_global_settings()
    base = dict(track_max_individuals=n_fish, track_max_speed=300,
                cm_per_pixel=1.0, frame_rate=25, track_threshold=20,
                track_threshold_is_absolute=False,
                track_background_subtraction=True,
                track_size_filter=[[10, 90]], calculate_posture=False,
                match_mode="approximate", track_do_history_split=False)
    for k, v in {**base, **over}.items():
        s.set(k, v)
    return s


def as_dict(s):
    return {k: s[k] for k in DEFAULTS}


def render(positions, size=256, core=False):
    """Fish of 10x6 px at 80 on a background of 200; with `core`, bodies
    at 120 with a 6x4 core at 60 (threshold escalation separates them)."""
    img = np.full((size, size), 200, np.uint8)
    for x, y in positions:
        x, y = int(x), int(y)
        if core:
            np.minimum(img[y:y + 6, x:x + 10], 120,
                       out=img[y:y + 6, x:x + 10])
            img[y + 1:y + 5, x + 2:x + 8] = 60
        else:
            img[y:y + 6, x:x + 10] = 80
    return img


def _walk(n, seed, n_frames, x0, dx, y0, dy, sigma):
    rng = np.random.default_rng(seed)
    pos = np.array([[x0 + dx * i, y0 + dy * i] for i in range(n)], float)
    vel = rng.normal(0, sigma, (n, 2))
    frames = []
    for _ in range(n_frames):
        frames.append(render(pos))
        pos = np.clip(pos + vel, 5, 230)
    return frames


def scene_separated():
    """tests/test_device_engine.py:92: four fish far apart."""
    return _walk(4, 1, 40, 30.0, 50, 40.0, 40, 1.5), settings(4), 16


def scene_fused():
    """tests/test_device_engine.py:136: three fish, chunk 8."""
    return _walk(3, 3, 30, 40.0, 60, 60.0, 50, 2.0), settings(3), 8


def scene_multirange_size():
    """tests/test_device_engine.py:207: fish 0 vanishes and a gap-size
    decoy appears on its path."""
    frames = []
    for f in range(30):
        img = np.full((256, 256), 200, np.uint8)
        if f < 15:
            img[40:44, 30 + 2 * f:38 + 2 * f] = 80
        else:
            img[38:44, 28 + 2 * f:38 + 2 * f] = 80
        img[200:204, 30 + 2 * f:38 + 2 * f] = 80
        frames.append(img)
    return frames, settings(
        2, track_size_filter=[[10, 45], [100, 400]]), 10


def scene_multirange_detect():
    """tests/test_device_engine.py:252: a blob in no detect range."""
    frames = []
    for _ in range(8):
        img = np.full((128, 128), 200, np.uint8)
        img[60:66, 50:60] = 80
        frames.append(img)
    return frames, settings(
        1, detect_size_filter=[[10, 45], [100, 400]]), 8


def scene_merge_heavy():
    """tests/test_device_engine.py:112 without history splits: two fish
    cross, their merged blob is over the size maximum."""
    frames = []
    for f in range(60):
        dx = abs(30 - f) - 10
        frames.append(render([[120 - max(0, dx), 100],
                              [130 + max(0, dx), 100]]))
    return frames, settings(2), 16


def scene_assist_storm():
    """tests/test_device_engine.py:271 without history splits: a pair
    merged every other frame for 80 frames."""
    frames = []
    for f in range(80):
        x = 60 + f
        gap = 6 if f % 2 else 14
        frames.append(render([[x, 100], [x + gap, 100]]))
    return frames, settings(2), 16


def scene_start_merged():
    """A pair merged at frame 0 that drifts apart: the start frame splits
    the oversized blob by threshold escalation."""
    frames = [render([[80 - f, 100], [88 + f, 100]], core=True)
              for f in range(24)]
    return frames, settings(2), 8


def scene_pale_halo():
    """Fish joined by a halo that passes the detect threshold but not
    the track threshold: the prefilter re-splits the blob."""
    frames = []
    for f in range(20):
        img = np.full((128, 128), 200, np.uint8)
        img[40:52, 20 + f:60 + f] = 184
        img[42:48, 22 + f:32 + f] = 80
        img[44:50, 45 + f:55 + f] = 80
        img[90:96, 30:40] = 80
        frames.append(img)
    return frames, settings(3), 8


SCENES = {
    "separated": scene_separated,
    "fused": scene_fused,
    "multirange_size": scene_multirange_size,
    "multirange_detect": scene_multirange_detect,
    "merge_heavy": scene_merge_heavy,
    "assist_storm": scene_assist_storm,
    "start_merged": scene_start_merged,
}


def detect_kwargs(s):
    return dict(threshold=int(s["detect_threshold"]),
                absolute=bool(s["detect_threshold_is_absolute"]),
                track_threshold=int(s["track_threshold"]),
                track_absolute=bool(s["track_threshold_is_absolute"]))


def assert_history_equal(ref, got, n_frames):
    for f in range(n_frames):
        hr = ref.history.get(f)
        hg = got.history.get(f)
        assert (hr is None) == (hg is None), f
        if hr is None:
            continue
        np.testing.assert_array_equal(hg["fish"], hr["fish"], err_msg=f)
        for k in ("x", "y", "prob"):
            np.testing.assert_allclose(hg[k], hr[k], rtol=0, atol=TOL,
                                       err_msg=f"{f} {k}")


@pytest.mark.parametrize("name", list(SCENES) + ["pale_halo"])
def test_fast_tracker_equals_jax(name):
    frames, s, _ = (scene_pale_halo if name == "pale_halo"
                    else SCENES[name])()
    bg = np.full(frames[0].shape, 200, np.uint8)
    det = detect_kwargs(s)
    ref = JaxFastTracker(s, bg)
    got = FastTracker(as_dict(s), bg)
    for i, img in enumerate(frames):
        ref.add_frame(i, i / 25.0, **jax_label_blobs_raw(img, bg, **det))
        got.add_frame(i, i / 25.0, **label_blobs_raw(img, bg, **det))
    assert got.n_fish == ref.n_fish > 0
    assert_history_equal(ref, got, len(frames))
    for k in ("last_frame", "last_x", "last_y", "n_basic", "trk_start",
              "prev_trk_end"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    assert got.closed_tracklets == ref.closed_tracklets
    assert [got.statistics[f].number_fish for f in range(len(frames))] \
        == [ref.statistics[f].number_fish for f in range(len(frames))]


def test_fast_tracker_add_frame_blobs_equals_add_frame():
    frames, s, _ = scene_pale_halo()
    bg = np.full(frames[0].shape, 200, np.uint8)
    det = detect_kwargs(s)
    a = FastTracker(as_dict(s), bg)
    b = FastTracker(as_dict(s), bg)
    for i, img in enumerate(frames):
        a.add_frame(i, i / 25.0, **label_blobs_raw(img, bg, **det))
        # blobs without stats take the native stats path
        b.add_frame_blobs(i, i / 25.0, [
            TrackBlob(x.lines, x.pixels, stats=None if i % 2 else x.stats)
            for x in label_blobs(img, bg, **det)])
    assert_history_equal(a, b, len(frames))


def test_start_frame_split_creates_both_fish():
    frames, s, _ = scene_start_merged()
    bg = np.full(frames[0].shape, 200, np.uint8)
    tr = FastTracker(as_dict(s), bg)
    tr.add_frame(0, 0.0, **label_blobs_raw(frames[0], bg,
                                           **detect_kwargs(s)))
    assert tr.n_fish == 2


@pytest.mark.parametrize("key,value", [
    ("match_mode", "benchmark"),
    ("track_threshold_2", 30),
    ("posture_closing_steps", 1),
    ("manual_matches", {0: {0: 1}}),
    ("track_threshold", 0),
])
def test_unsupported_configs_raise_in_constructor(key, value):
    """With posture on (the default), which closing steps keep off the
    engine, as in the JAX package."""
    d = as_dict(settings(2, calculate_posture=True))
    check_supported(d)
    d[key] = value
    with pytest.raises(EngineUnsupported):
        check_supported(d)
    with pytest.raises(EngineUnsupported):
        FastTracker(d, np.zeros((8, 8), np.uint8))


@pytest.mark.parametrize("name", ["separated", "merge_heavy"])
def test_speed_decay_equals_jax(name):
    """track_speed_decay 0.7 (the golden fixture's setting), once refused
    by the constructor: the port's host engine estimates from the motion
    window like the JAX package's and tracks the same."""
    frames, s, _ = SCENES[name]()
    s.set("track_speed_decay", 0.7)
    bg = np.full(frames[0].shape, 200, np.uint8)
    det = detect_kwargs(s)
    ref = JaxFastTracker(s, bg)
    got = FastTracker(as_dict(s), bg)
    assert got.decay_active and ref.decay_active
    for i, img in enumerate(frames):
        ref.add_frame(i, i / 25.0, **jax_label_blobs_raw(img, bg, **det))
        got.add_frame(i, i / 25.0, **label_blobs_raw(img, bg, **det))
    assert_history_equal(ref, got, len(frames))
    np.testing.assert_array_equal(got.win, ref.win)
