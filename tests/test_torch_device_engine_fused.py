"""Port parity: the port's DeviceTracker (``device="cpu"``) against the JAX
package's DeviceTracker on the CPU, through the fused raw-frames path
(``track_frames``: detection and scan in one pass, flagged frames
labelled and replayed on the host). Same rule as
``test_torch_device_engine.py``."""
import numpy as np
import pytest

from trex_tpu.track.device_engine import DeviceTracker as JaxDeviceTracker
from trex_tpu_torch.track.device_engine import DeviceTracker
from trex_tpu_torch.track.engine import EngineUnsupported

from test_torch_device_engine import check_expected, compare_engines
from test_torch_engine import (SCENES, as_dict, one_torch_thread,  # noqa: F401
                               settings)


@pytest.mark.parametrize("name", list(SCENES))
def test_fused_path_equals_jax(name):
    frames, s, chunk = SCENES[name]()
    frames = np.stack(frames)
    bg = np.full(frames.shape[1:], 200, np.uint8)
    ref = JaxDeviceTracker(s, bg, chunk=chunk).track_frames(frames)
    got = DeviceTracker(as_dict(s), bg, chunk=chunk,
                        device="cpu").track_frames(frames)
    compare_engines(ref, got, len(frames))
    check_expected(name, got)
    assert got.scan_seconds > 0
    if name == "multirange_detect":
        assert got.n_fish == 0


def test_track_frames_resumes_across_calls():
    """Two calls of track_frames continue one track (start_frame
    offsets the second batch) like one call over all frames."""
    frames, s, chunk = SCENES["fused"]()
    frames = np.stack(frames)
    bg = np.full(frames.shape[1:], 200, np.uint8)
    one = DeviceTracker(as_dict(s), bg, chunk=chunk,
                        device="cpu").track_frames(frames)
    two = DeviceTracker(as_dict(s), bg, chunk=chunk, device="cpu")
    two.track_frames(frames[:13]).track_frames(frames[13:], start_frame=13)
    assert two.end_frame == one.end_frame == len(frames) - 1
    for f in range(len(frames)):
        np.testing.assert_array_equal(two.history[f]["fish"],
                                      one.history[f]["fish"])
        np.testing.assert_array_equal(two.history[f]["x"],
                                      one.history[f]["x"])


@pytest.mark.parametrize("key,value", [
    ("match_mode", "benchmark"),
    ("track_ignore", [[[0, 0], [4, 0], [4, 4]]]),
    ("posture_closing_steps", 1),
])
def test_unsupported_configs_raise_in_constructor(key, value):
    """With posture on (the default), which closing steps keep off the
    engine, as in the JAX package."""
    d = as_dict(settings(2, calculate_posture=True))
    DeviceTracker(d, np.zeros((8, 8), np.uint8), device="cpu")
    d[key] = value
    with pytest.raises(EngineUnsupported):
        DeviceTracker(d, np.zeros((8, 8), np.uint8), device="cpu")


def test_speed_decay_equals_jax():
    """track_speed_decay 0.5, once refused by the constructor: the fused
    path tracks like the JAX package's DeviceTracker."""
    frames, s, chunk = SCENES["fused"]()
    s.set("track_speed_decay", 0.5)
    frames = np.stack(frames)
    bg = np.full(frames.shape[1:], 200, np.uint8)
    ref = JaxDeviceTracker(s, bg, chunk=chunk).track_frames(frames)
    got = DeviceTracker(as_dict(s), bg, chunk=chunk,
                        device="cpu").track_frames(frames)
    assert got.P.do_decay
    compare_engines(ref, got, len(frames))
