"""Port parity in archive mode (``keep_individuals``): the port's
FastTracker and DeviceTracker (blob path, ``device="cpu"``) build the
same per-individual archives and posture records as the JAX package's
same engines on the same frames.

Rule: ``tests/test_archive.py::_assert_individuals_equal`` (per
individual the frames, centroids and their velocities and angles, blob
ids, pixel counts, split flags, lines, pixels and tracklets, all exactly
equal), and for posture every record's outline, midline segments and
heights, length, angle, offset, tail index, head and posture-centroid
motion records exactly equal. The engines' histories are equal by
``test_torch_decay.py``'s rule (fish ids exact, positions within 1e-6,
probabilities within 1e-5)."""
import numpy as np
import pytest

from trex_tpu.ops.labeling import label_blobs as jax_label_blobs
from trex_tpu.ops.labeling import label_blobs_raw as jax_label_blobs_raw
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.device_engine import DeviceTracker as JaxDeviceTracker
from trex_tpu.track.engine import FastTracker as JaxFastTracker
from trex_tpu_torch.ops.labeling import label_blobs, label_blobs_raw
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.device_engine import DeviceTracker
from trex_tpu_torch.track.engine import EngineUnsupported, FastTracker

import chip_smoke
from test_archive import _assert_individuals_equal
from test_engine import _settings, _synth
from test_torch_decay import assert_history_close
from test_torch_engine import as_dict, one_torch_thread  # noqa: F401


def _det(s):
    return dict(threshold=int(s["detect_threshold"]),
                absolute=bool(s["detect_threshold_is_absolute"]),
                track_threshold=int(s["track_threshold"]),
                track_absolute=bool(s["track_threshold_is_absolute"]))


def _drive_fast(s, bg, frames):
    ref = JaxFastTracker(s, bg, keep_individuals=True)
    got = FastTracker(as_dict(s), bg, keep_individuals=True)
    det = _det(s)
    for i, f in enumerate(frames):
        ref.add_frame(i, i / 25.0, **jax_label_blobs_raw(f, bg, **det))
        got.add_frame(i, i / 25.0, **label_blobs_raw(f, bg, **det))
    return ref, got


def _drive_device(s, bg, frames, chunk):
    ref = JaxDeviceTracker(s, bg, chunk=chunk, keep_individuals=True)
    got = DeviceTracker(as_dict(s), bg, chunk=chunk, keep_individuals=True,
                        device="cpu")
    det = _det(s)
    for i, f in enumerate(frames):
        ref.add_frame_blobs(i, i / 25.0, [
            JaxTrackBlob(b.lines, b.pixels, stats=b.stats)
            for b in jax_label_blobs(f, bg, **det)])
        got.add_frame_blobs(i, i / 25.0, [
            TrackBlob(b.lines, b.pixels, stats=b.stats)
            for b in label_blobs(f, bg, **det)])
    return ref.finalize(), got.finalize()


def assert_postures_equal(ref, got):
    """Posture records of two engines' individuals, exactly equal;
    returns the number of midlines compared."""
    n_post = 0
    for fid, ind in ref.individuals.items():
        e = got.individuals[fid]
        assert [p.frame for p in ind.posture] == [p.frame for p in e.posture]
        for a, b in zip(ind.posture, e.posture):
            assert (a.midline is None) == (b.midline is None)
            assert (a.outline is None) == (b.outline is None)
            if a.outline is not None:
                np.testing.assert_array_equal(a.outline, b.outline)
            if a.midline is None:
                continue
            n_post += 1
            np.testing.assert_array_equal(a.midline.segments,
                                          b.midline.segments)
            np.testing.assert_array_equal(a.midline.heights,
                                          b.midline.heights)
            assert a.midline.len == b.midline.len
            assert a.midline.angle == b.midline.angle
            assert a.midline.offset == b.midline.offset
            assert a.midline.tail_index == b.midline.tail_index
            assert a.midline.head_index == b.midline.head_index
            assert a.midline_length == b.midline_length
            assert a.head.x == b.head.x and a.head.y == b.head.y
            assert a.head.vx == b.head.vx
            assert a.centroid_posture.x == b.centroid_posture.x
            assert a.centroid_posture.y == b.centroid_posture.y
    return n_post


@pytest.mark.parametrize("n_fish,size,seed,decay,mode", [
    (32, 256, 1, 1.0, "automatic"), (48, 320, 2, 0.7, "automatic"),
    (24, 224, 9, 0.7, "approximate")])
def test_fast_tracker_individuals_equal_jax(n_fish, size, seed, decay,
                                            mode):
    """tests/test_archive.py:62-71, the decay case included."""
    s = _settings(n_fish)
    s.set("track_speed_decay", decay)
    s.set("match_mode", mode)
    s.set("track_do_history_split", True)
    bg, frames = _synth(40, n_fish, size, seed)
    ref, got = _drive_fast(s, bg, frames)
    assert_history_close(ref, got, len(frames))
    _assert_individuals_equal(ref, got)
    assert len(got.individuals) == got.n_fish > 0
    assert any(b.blob.split for ind in got.individuals.values()
               for b in ind.basic)


def test_fast_tracker_posture_records_equal_jax():
    """tests/test_archive.py:74: posture records under decay."""
    s = _settings(24)
    s.set("calculate_posture", True)
    s.set("outline_resample", 0.5)
    s.set("track_speed_decay", 0.7)
    bg, frames = _synth(30, 24, 256, 4)
    ref, got = _drive_fast(s, bg, frames)
    _assert_individuals_equal(ref, got)
    assert assert_postures_equal(ref, got) > 50


@pytest.mark.parametrize("decay", [1.0, 0.7])
def test_device_tracker_blob_path_individuals_equal_jax(decay):
    """tests/test_archive.py:158-171: the committed card frames archive
    from the host tables through fish_row, the replayed frames inside the
    helper engine."""
    s = _settings(24)
    s.set("calculate_posture", True)
    s.set("outline_resample", 0.5)
    s.set("track_speed_decay", decay)
    bg, frames = _synth(30, 24, 256, 4)
    ref, got = _drive_device(s, bg, frames, chunk=8)
    assert got.assist_frames == ref.assist_frames
    assert_history_close(ref, got, len(frames))
    _assert_individuals_equal(ref, got)
    assert assert_postures_equal(ref, got) > 50
    assert sorted(got.frame_archive) == list(range(len(frames)))


def test_device_tracker_asym_scene_individuals_equal_jax():
    """The asymmetric posture scene (chip_smoke.asym_scene) on the blob
    path, base configuration: archives and posture records equal."""
    bg, frames, d = chip_smoke.asym_scene()
    from trex_tpu.config import reset_global_settings

    s = reset_global_settings()
    for k, v in d.items():
        s.set(k, v)
    ref, got = _drive_device(s, bg, frames, chunk=16)
    _assert_individuals_equal(ref, got)
    assert assert_postures_equal(ref, got) > 60


def test_archive_off_keeps_positional_surface():
    """tests/test_archive.py:144-155."""
    s = _settings(8)
    bg, frames = _synth(5, 8, 128, 0)
    for eng in (FastTracker(as_dict(s), bg),
                DeviceTracker(as_dict(s), bg, device="cpu")):
        for i, f in enumerate(frames):
            eng.add_frame_blobs(i, i / 25.0, [
                TrackBlob(b.lines, b.pixels, stats=b.stats)
                for b in label_blobs(f, bg, threshold=15, absolute=False,
                                     track_threshold=20,
                                     track_absolute=False)])
        if isinstance(eng, DeviceTracker):
            eng.finalize()
        assert not hasattr(eng, "individuals")
        assert eng.history and not eng.frame_archive


def test_track_frames_refuses_archive_mode():
    s = _settings(2)
    frames = np.full((2, 32, 32), 200, np.uint8)
    dev = DeviceTracker(as_dict(s), frames[0], keep_individuals=True,
                        device="cpu")
    with pytest.raises(EngineUnsupported, match="add_frame_blobs"):
        dev.track_frames(frames)
