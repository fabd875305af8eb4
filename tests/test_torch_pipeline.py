"""The port's pipeline (trex_tpu_torch/pipeline.py) against the JAX
package's: Segmenter with host and device detection writes the JAX
Segmenter's .pv payload (masks and pixel bytes, frame for frame), the
DeviceDetector falls back to the host labeler on overflowing frames,
TrackingState under track_engine fast and device builds the JAX
package's individuals, and select_tracker's rules. Integer outputs and
bytes compare exactly; positions and postures compare with ==."""
import cv2
import numpy as np
import pytest
import torch

from test_archive import _assert_individuals_equal
from test_torch_archive import assert_postures_equal
from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.io.pv import PVFile as JaxPVFile
from trex_tpu.pipeline import Segmenter as JaxSegmenter
from trex_tpu.pipeline import TrackingState as JaxTrackingState
from trex_tpu_torch import pipeline
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io.pv import PVFile
from trex_tpu_torch.track.device_engine import DeviceTracker
from trex_tpu_torch.track.engine import EngineUnsupported, FastTracker

SEG = dict(track_max_individuals=3, track_threshold=20,
           track_threshold_is_absolute=False, detect_threshold=15,
           detect_threshold_is_absolute=False, track_size_filter=[[5, 400]],
           calculate_posture=False, frame_rate=25, cm_per_pixel=1.0,
           averaging_method="max", meta_encoding="gray",
           track_background_subtraction=True)


def _apply(s, values):
    for k, v in values.items():
        s.set(k, v)
    return s


def _seg_frames(tmp_path, stripes=True):
    """tests/test_runcc.py's three moving fish; the last frame adds a
    striped band of more runs than the DeviceDetector's cap (4096)."""
    frames = []
    for f in range(12):
        img = np.full((96, 128), 200, np.uint8)
        for i in range(3):
            x = 10 + 30 * i + f
            y = 20 + 20 * i
            img[y:y + 6, x:x + 10] = 80
        frames.append(img)
    if stripes:
        frames[-1][:76, ::2] = 60
    src = tmp_path / "frames"
    src.mkdir()
    for i, fr in enumerate(frames):
        cv2.imwrite(str(src / f"f_{i:03d}.png"), fr)
    return str(src / "f_%03d.png")


def _payload(pv_cls, path):
    out = []
    with pv_cls.open(path) as pv:
        for i in range(len(pv)):
            fr = pv.read_frame(i)
            out.append([(np.asarray(m).tobytes(), np.asarray(px).tobytes())
                        for m, px in zip(fr.masks, fr.pixels)])
    return out


def _positions(tracker):
    return {fid: [(b.frame, b.centroid.x, b.centroid.y) for b in ind.basic]
            for fid, ind in tracker.individuals.items()}


def test_segmenter_device_detection_equals_host_and_jax(tmp_path):
    """Port of tests/test_runcc.py::test_segmenter_device_engine_matches_host:
    detect_engine host and device (its plain path) give the JAX
    Segmenter's payload and tracking; the striped frame overflows the
    detector's caps and goes to the host labeler."""
    pattern = _seg_frames(tmp_path)
    ref_s = _apply(jax_reset(), SEG)
    ref = JaxSegmenter(ref_s, pattern, tmp_path / "jax.pv", track=True)
    ref_pos = _positions(ref.run())
    want = _payload(JaxPVFile, tmp_path / "jax.pv")
    assert len(want) == 12 and len(want[-1]) > 40
    for engine in ("host", "device"):
        s = _apply(reset_global_settings(), dict(SEG, detect_engine=engine))
        seg = pipeline.Segmenter(s, pattern, tmp_path / f"{engine}.pv",
                                 track=True, device="cpu")
        tracker = seg.run()
        assert type(tracker) is FastTracker  # auto on the CPU
        assert _payload(PVFile, tmp_path / f"{engine}.pv") == want, engine
        assert _positions(tracker) == ref_pos, engine
        if engine == "device":
            assert (seg.detector.frames, seg.detector.overflow_frames) \
                == (12, 1)
        else:
            assert seg.detector is None


def test_device_detector_batches_equal_host_detect_frame():
    """DeviceDetector.detect over batches that do not divide the frame
    count (the batch pads) equals detect_frame per frame, with the fused
    track-threshold recount."""
    rng = np.random.default_rng(3)
    s = _apply(reset_global_settings(), dict(SEG, detect_batch_size=4))
    bg = np.full((64, 80), 200, np.uint8)
    frames = []
    for _ in range(7):
        img = bg.copy()
        for _ in range(5):
            y, x = rng.integers(0, 56), rng.integers(0, 68)
            img[y:y + 6, x:x + 10] = rng.integers(60, 140)
        frames.append(img)
    det = pipeline.select_detector(_apply(s, {"detect_engine": "device"}),
                                   bg, device="cpu")
    got = det.detect(frames)
    assert det.frames == 7 and det.overflow_frames == 0
    for img, blobs in zip(frames, got):
        want = pipeline.detect_frame(img, bg, s)
        assert len(blobs) == len(want)
        for a, b in zip(blobs, want):
            np.testing.assert_array_equal(a.lines, b.lines)
            np.testing.assert_array_equal(a.pixels, b.pixels)
            assert a._recount_cache == b._recount_cache


def _fish_pv(tmp_path):
    """tests/test_engine.py::test_fast_engine_through_tracking_state's
    eight fish, converted by the port."""
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    bg = np.full((128, 128), 200, np.uint8)
    for i in range(12):
        img = bg.copy()
        for k in range(8):
            img[20 + k * 12:26 + k * 12, 10 + i * 3:20 + i * 3] = 90
            img[21 + k * 12, 10 + i * 3 + k % 3] = 40
        cv2.imwrite(str(frames_dir / f"f_{i:03d}.png"), img)
    s = _apply(reset_global_settings(), TRACK)
    pipeline.Segmenter(s, str(frames_dir / "f_%03d.png"),
                       tmp_path / "t.pv", track=False, device="cpu").run()
    return tmp_path / "t.pv"


TRACK = dict(track_max_individuals=8, track_max_speed=300, cm_per_pixel=1.0,
             frame_rate=25, track_threshold=20,
             track_threshold_is_absolute=False,
             track_background_subtraction=True,
             track_size_filter=[[20, 400]], calculate_posture=True,
             outline_resample=0.5, match_mode="automatic",
             detect_threshold=15, detect_threshold_is_absolute=False,
             meta_encoding="gray")


@pytest.mark.parametrize("engine", ["fast", "device"])
def test_tracking_state_individuals_equal_jax(tmp_path, engine):
    """Port of tests/test_engine.py::test_fast_engine_through_tracking_state:
    the track task on a .pv, under track_engine fast and device (its
    plain path), builds the JAX package's individuals and postures."""
    pv_path = _fish_pv(tmp_path)
    ref_s = _apply(jax_reset(), dict(TRACK, track_engine="fast"))
    ref = JaxTrackingState(ref_s, pv_path).run()
    s = _apply(reset_global_settings(), dict(TRACK, track_engine=engine))
    state = pipeline.TrackingState(s, pv_path, device="cpu")
    got = state.run()
    assert type(got) is (FastTracker if engine == "fast" else DeviceTracker)
    assert len(got.individuals) == 8
    _assert_individuals_equal(ref, got)
    assert assert_postures_equal(ref, got) > 50


def test_select_tracker_rules(monkeypatch):
    bg = np.full((32, 32), 200, np.uint8)
    s = _apply(reset_global_settings(), TRACK)
    assert type(pipeline.select_tracker(s, bg, device="cpu")) is FastTracker
    s.set("track_engine", "device")
    tr = pipeline.select_tracker(s, bg, device="cpu")
    assert type(tr) is DeviceTracker and tr.device == torch.device("cpu")
    assert tr.archive_mode
    s.set("track_engine", "fast")
    assert not pipeline.select_tracker(s, bg, need_individuals=False,
                                       device="cpu").archive_mode
    with pytest.raises(EngineUnsupported, match="non-gray"):
        pipeline.select_tracker(s, bg, gray_pixels=False, device="cpu")
    s.set("track_engine", "object")
    with pytest.raises(EngineUnsupported, match="A item 2"):
        pipeline.select_tracker(s, bg, device="cpu")
    # auto, when both fast engines refuse the configuration
    s.set("track_engine", "auto")
    s.set("manual_matches", {0: {0: 1}})
    with pytest.raises(EngineUnsupported, match="A item 2"):
        pipeline.select_tracker(s, bg, device="cpu")
    s.set("manual_matches", {})
    s.set("track_engine", "sideways")
    with pytest.raises(ValueError, match="track_engine"):
        pipeline.select_tracker(s, bg, device="cpu")
    # no card, no device named: auto raises rather than track on the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s.set("track_engine", "auto")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.select_tracker(s, bg)
    s.set("track_engine", "device")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.select_tracker(s, bg)
    assert not pipeline._accelerator_healthy(torch.device("cuda"))


def test_select_tracker_auto_on_a_card_never_tracks_on_the_host(monkeypatch):
    """On a (mocked) healthy card, auto returns the DeviceTracker, and
    a configuration the DeviceTracker refuses raises naming the object
    tracker instead of handing tracking to the host FastTracker."""
    import trex_tpu_torch.track.device_engine as device_engine

    bg = np.full((32, 32), 200, np.uint8)
    s = _apply(reset_global_settings(), TRACK)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pipeline, "_accelerator_healthy", lambda dev: True)
    built = []

    class CardTracker:
        def __init__(self, settings, background, keep_individuals, device):
            built.append((keep_individuals, device))

    monkeypatch.setattr(device_engine, "DeviceTracker", CardTracker)
    assert type(pipeline.select_tracker(s, bg)) is CardTracker
    assert built == [(True, torch.device("cuda"))]

    class RefusingTracker:
        def __init__(self, *a, **k):
            raise EngineUnsupported("refused by the device engine")

    monkeypatch.setattr(device_engine, "DeviceTracker", RefusingTracker)
    with pytest.raises(EngineUnsupported,
                       match="A item 2.*refused by the device engine"):
        pipeline.select_tracker(s, bg)
    # the real DeviceTracker refuses before it touches the card
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pipeline, "_accelerator_healthy", lambda dev: True)
    s.set("manual_matches", {0: {0: 1}})
    with pytest.raises(EngineUnsupported, match="A item 2"):
        pipeline.select_tracker(s, bg)


def test_select_detector_rules():
    bg = np.full((32, 32), 200, np.uint8)
    s = reset_global_settings()
    assert pipeline.select_detector(s, bg, device="cpu") is None
    s.set("detect_engine", "device")
    det = pipeline.select_detector(s, bg, device="cpu")
    assert det.kw["max_runs"] == 4096 and det.kw["max_blobs"] == 1024
    s.set("use_closing", True)
    with pytest.raises(ValueError, match="morphology"):
        pipeline.select_detector(s, bg, device="cpu")
    s.set("use_closing", False)
    s.set("detect_engine", "gpu")
    with pytest.raises(ValueError, match="detect_engine"):
        pipeline.select_detector(s, bg, device="cpu")
