"""Port parity: the port's DeviceTracker (``device="cpu"``) against the JAX
package's DeviceTracker on the CPU, through the blob-list ingestion
path (``add_frame_blobs`` / ``finalize``, the scan over host-built
candidate tables).

Equal: the history of every frame (fish ids exact, x, y and prob within
1e-6: committed device frames carry the scan's float32 values, which
both scans compute alike, and replayed frames the host engine's
float64), the assist frames, n_fish and whether the engine demoted.
The fused raw-frames path is in ``test_torch_device_engine_fused.py``.
"""
import numpy as np
import pytest

from trex_tpu.ops.labeling import label_blobs as jax_label_blobs
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.device_engine import DeviceTracker as JaxDeviceTracker
from trex_tpu.track.device_engine import positions_of as jax_positions_of
from trex_tpu_torch.ops.labeling import label_blobs
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.device_engine import (DeviceTracker,
                                                export_positions,
                                                positions_of)

from test_torch_engine import (SCENES, as_dict, assert_history_equal,
                               detect_kwargs)

# assists and demotion of the JAX twin on the CPU, the same through both
# ingestion paths
EXPECTED = {"merge_heavy": (21, False), "assist_storm": (32, True)}


def compare_engines(ref, got, n_frames):
    assert got.assist_frames == ref.assist_frames
    assert got.n_fish == ref.n_fish
    assert got.demoted == ref.demoted
    assert sorted(got.history) == sorted(ref.history) \
        == list(range(n_frames))
    assert_history_equal(ref, got, n_frames)
    assert [got.statistics[f].number_fish for f in range(n_frames)] \
        == [ref.statistics[f].number_fish for f in range(n_frames)]
    if ref.assist_frames:
        assert all(got.statistics[f].adding_seconds > 0
                   for f in got.assist_frames)


def check_expected(name, got):
    if name in EXPECTED:
        assert (len(got.assist_frames), got.demoted) == EXPECTED[name]
    if name == "start_merged":
        assert got.assist_frames[0] == 0 and got.n_fish == 2


def _feed(tracker, label, blob_cls, frames, bg, det):
    for i, img in enumerate(frames):
        tracker.add_frame_blobs(i, i / 25.0, [
            blob_cls(b.lines, b.pixels, stats=b.stats)
            for b in label(img, bg, **det)])
    return tracker.finalize()


def run_blob_path(name):
    frames, s, chunk = SCENES[name]()
    bg = np.full(frames[0].shape, 200, np.uint8)
    det = detect_kwargs(s)
    ref = _feed(JaxDeviceTracker(s, bg, chunk=chunk), jax_label_blobs,
                JaxTrackBlob, frames, bg, det)
    got = _feed(DeviceTracker(as_dict(s), bg, chunk=chunk, device="cpu"),
                label_blobs, TrackBlob, frames, bg, det)
    return ref, got, len(frames)


@pytest.mark.parametrize("name", list(SCENES))
def test_blob_path_equals_jax(name):
    ref, got, n = run_blob_path(name)
    compare_engines(ref, got, n)
    check_expected(name, got)


def _first_departure(host, dev, n_frames):
    """First frame where a host assignment is missing from the device
    history or sits elsewhere (tests/test_device_engine.py's rule)."""
    for f in range(n_frames):
        hd = dev.history[f]
        dmap = {int(i): x for i, x in zip(hd["fish"], hd["x"])}
        hh = host.history.get(f, {"fish": [], "x": []})
        if any(int(i) not in dmap or abs(dmap[int(i)] - x) >= 1e-4
               for i, x in zip(hh["fish"], hh["x"])):
            return f
    return None


def test_dense_scene_keeps_the_reference_departure():
    """ROADMAP.md C1: at the benchmark scene's density (16 fish in
    256^2), the JAX package's DeviceTracker departs from its FastTracker
    at frame 30, because the scan counts fish 5's recent samples from
    its seen ring (9) where the host's tracklet walk stops at the 16-frame
    gap (1). The port reproduces the JAX DeviceTracker, departure
    included."""
    from trex_tpu.config import reset_global_settings
    from trex_tpu.ops.labeling import label_blobs_raw as jax_raw
    from trex_tpu.track.engine import FastTracker as JaxFastTracker

    import chip_smoke

    T = 32
    bg, frames = chip_smoke.synth_frames(T, n_fish=16, size=256, seed=0)
    d = chip_smoke.track_settings()
    s = reset_global_settings()
    for k, v in d.items():
        s.set(k, v)
    ref = JaxDeviceTracker(s, bg, chunk=T).track_frames(frames)
    got = DeviceTracker(d, bg, chunk=T, device="cpu").track_frames(frames)
    compare_engines(ref, got, T)
    host = JaxFastTracker(s, bg)
    for f in range(T):
        host.add_frame(f, f / 25.0, **jax_raw(
            frames[f], bg, threshold=15, absolute=True, track_threshold=20,
            track_absolute=False))
    assert _first_departure(host, ref, T) == 30
    assert _first_departure(host, got, T) == 30
    assert int(host._recent_samples(np.array([5]), 30)[0]) == 1


def test_positions_and_export(tmp_path):
    ref, got, n = run_blob_path("separated")
    want = jax_positions_of(ref)
    have = got.positions()
    for k in ("frames", "fish_seen"):
        np.testing.assert_array_equal(have[k], want[k])
    for k in ("fish_x", "fish_y"):
        np.testing.assert_allclose(have[k], want[k], rtol=0, atol=1e-6)
    export_positions(got, tmp_path / "pos.npz")
    saved = np.load(tmp_path / "pos.npz")
    assert set(saved.files) == set(have)
    np.testing.assert_array_equal(saved["fish_x"], have["fish_x"])
    assert positions_of(DeviceTracker(
        as_dict(SCENES["separated"]()[1]), np.zeros((8, 8), np.uint8),
        device="cpu"))["fish_x"].shape == (0, 4)
