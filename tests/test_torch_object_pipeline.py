"""The object Tracker through the port's pipeline: `select_tracker`'s
routing (what `auto` picks, and why, on a mocked card and on the CPU),
the port's Tracker held to the port's FastTracker(keep_individuals=True)
as tests/test_archive.py holds the JAX package's (archives, postures and
export files equal), and the Segmenter's and TrackingState's object
branch equal to the JAX package's under the registry's defaults (the
individuals and their postures exactly equal, as
tests/test_archive.py::_assert_individuals_equal and
test_torch_archive.py::assert_postures_equal compare them)."""
import cv2
import numpy as np
import pytest
import torch

from test_archive import _assert_individuals_equal
from test_engine import _synth
from test_torch_archive import assert_postures_equal
from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.pipeline import Segmenter as JaxSegmenter
from trex_tpu.pipeline import TrackingState as JaxTrackingState
from trex_tpu.track.tracker import Tracker as JaxTracker
from trex_tpu_torch import pipeline
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.export.export import export_data, export_posture
from trex_tpu_torch.export.results import save_results
from trex_tpu_torch.ops.labeling import label_blobs_raw
from trex_tpu_torch.track.engine import FastTracker
from trex_tpu_torch.track.tracker import Tracker

from test_torch_tracker import ENGINE, apply


def test_select_tracker_routes_registry_defaults_to_the_object_tracker(
        monkeypatch):
    bg = np.full((32, 32), 200, np.uint8)
    s = reset_global_settings()
    tr = pipeline.select_tracker(s, bg, device="cpu")
    assert type(tr) is Tracker and tr.background is bg
    assert tr.engine_choice == ("track_engine=auto: object Tracker (host), "
                                "FastTracker refuses track_threshold == 0")
    s.set("track_engine", "object")
    assert pipeline.select_tracker(s, bg, device="cpu").engine_choice \
        == "track_engine=object: object Tracker (host)"
    s.set("track_engine", "auto")
    s.set("track_threshold", 20)
    tr = pipeline.select_tracker(s, bg, device="cpu")
    assert type(tr) is Tracker and tr.engine_choice.endswith(
        "FastTracker refuses track_background_subtraction off")
    tr = pipeline.select_tracker(s, bg, gray_pixels=False, device="cpu")
    assert tr.engine_choice.endswith("refuses non-gray blob pixels")

    # a healthy (mocked) card: the DeviceTracker's checks refuse the
    # registry's defaults before the engine is built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pipeline, "_accelerator_healthy", lambda dev: True)
    s = reset_global_settings()
    tr = pipeline.select_tracker(s, bg)
    assert type(tr) is Tracker
    assert tr.engine_choice == ("track_engine=auto: object Tracker (host), "
                                "DeviceTracker refuses track_threshold == 0")
    s.set("calculate_posture", True)
    s.set("posture_closing_steps", 2)
    s.set("track_threshold", 20)
    s.set("track_background_subtraction", True)
    tr = pipeline.select_tracker(s, bg)
    assert type(tr) is Tracker and "posture-closing" in tr.engine_choice
    # an unhealthy card raises: the object Tracker is a route for
    # settings, not a fallback for a failing card
    monkeypatch.setattr(pipeline, "_accelerator_healthy", lambda dev: False)
    with pytest.raises(RuntimeError, match="test compute"):
        pipeline.select_tracker(reset_global_settings(), bg)
    # no card and no device named: raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.select_tracker(reset_global_settings(), bg)


def _drive_pair(s, bg, frames):
    """The port's object Tracker (with run_postures) and its archived
    FastTracker over the same frames (tests/test_archive.py::_drive_pair
    over the port)."""
    tracker = Tracker(s, background=bg)
    eng = FastTracker(s, background=bg, keep_individuals=True)
    for i, f in enumerate(frames):
        pp = tracker.preprocess_frame(i, pipeline.detect_frame(f, bg, s),
                                      time=i / 25.0)
        tracker.add(pp)
        if s["calculate_posture"]:
            pipeline.run_postures(tracker, i, s, None)
        eng.add_frame(i, i / 25.0, **label_blobs_raw(
            f, bg, threshold=int(s["detect_threshold"]),
            absolute=bool(s["detect_threshold_is_absolute"]),
            track_threshold=int(s["track_threshold"]),
            track_absolute=bool(s["track_threshold_is_absolute"])))
    return tracker, eng


@pytest.mark.parametrize("n_fish,size,seed,posture", [
    (32, 256, 1, False), (24, 256, 4, True)])
def test_object_tracker_archives_equal_fast_tracker(tmp_path, n_fish, size,
                                                    seed, posture):
    s = apply(reset_global_settings(), dict(
        ENGINE, track_max_individuals=n_fish, calculate_posture=posture,
        outline_resample=0.5, output_posture_data=posture))
    bg, frames = _synth(24, n_fish, size, seed)
    tracker, eng = _drive_pair(s, bg, frames)
    _assert_individuals_equal(tracker, eng)
    assert not posture or assert_postures_equal(tracker, eng) > 50
    files = {}
    for name, tr in (("obj", tracker), ("eng", eng)):
        d = tmp_path / name
        paths = export_data(tr, s, d, "v") + [save_results(tr, s,
                                                           d / "v.results")]
        if posture:
            paths += export_posture(tr, s, d, "v")
        files[name] = {p.name: p.read_bytes() for p in paths}
    assert files["obj"] == files["eng"]


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """Five fish of unequal shade over 16 frames at 160^2, two crossing,
    as a PNG sequence."""
    root = tmp_path_factory.mktemp("object")
    rng = np.random.default_rng(11)
    pos = rng.uniform(20, 130, (5, 2))
    vel = rng.normal(0, 2.0, (5, 2))
    pos[1], vel[1], vel[0] = pos[0] + [36, 2], [-1.6, 0.0], [1.6, 0.0]
    (root / "f").mkdir()
    for i in range(16):
        img = np.full((160, 160), 200, np.uint8)
        for k, (x, y) in enumerate(pos):
            xi, yi = int(x), int(y)
            img[yi:yi + 7, xi:xi + 14] = 90
            img[yi + 2:yi + 5, xi + 10:xi + 14] = 40 + 12 * k
        cv2.imwrite(str(root / "f" / f"f_{i:03d}.png"), img)
        pos = np.clip(pos + vel, 5, 140)
    return root, str(root / "f" / "f_%03d.png")


# the conversion's own settings; every tracking setting keeps the
# registry's default
CONVERT = dict(meta_encoding="gray", averaging_method="max",
               average_samples=8, frame_rate=25, cm_per_pixel=1.0)


@pytest.mark.parametrize("over", [{}, dict(posture_closing_steps=1)])
def test_segmenter_object_branch_equals_jax(video, over):
    root, src = video
    tag = "closing" if over else "defaults"
    ref_s = apply(jax_reset(), dict(CONVERT, **over))
    ref = JaxSegmenter(ref_s, src, root / f"jax_{tag}.pv").run()
    s = apply(reset_global_settings(), dict(CONVERT, **over))
    seg = pipeline.Segmenter(s, src, root / f"port_{tag}.pv", device="cpu")
    got = seg.run()
    assert type(ref) is JaxTracker and type(got) is Tracker
    assert seg.engine_choice.endswith("FastTracker refuses track_threshold "
                                      "== 0")
    assert len(got.individuals) >= 5
    _assert_individuals_equal(ref, got)
    assert assert_postures_equal(ref, got) > 40


@pytest.mark.parametrize("over", [
    {}, dict(match_mode="benchmark"),
    dict(track_size_filter=[[40, 200]], track_do_history_split=True,
         track_max_speed=400, track_threshold=30,
         track_background_subtraction=True, track_engine="object")])
def test_tracking_state_object_branch_equals_jax(video, over):
    root, src = video
    pv = root / "state.pv"
    if not pv.exists():
        pipeline.Segmenter(apply(reset_global_settings(), CONVERT), src, pv,
                           track=False, device="cpu").run()
    ref = JaxTrackingState(apply(jax_reset(), over), pv).run()
    state = pipeline.TrackingState(apply(reset_global_settings(), over), pv,
                                   device="cpu")
    got = state.run()
    assert type(ref) is JaxTracker and type(got) is Tracker
    assert "object Tracker (host)" in state.engine_choice
    _assert_individuals_equal(ref, got)
    assert assert_postures_equal(ref, got) > 40
    assert [(st.number_fish, st.match_improvements)
            for _, st in sorted(got.statistics.items())] \
        == [(st.number_fish, st.match_improvements)
            for _, st in sorted(ref.statistics.items())]
    # the wall seconds the JAX package leaves 0
    assert all(st.loading_seconds > 0 and st.posture_seconds > 0
               for st in got.statistics.values())


def test_closed_loop_raises_naming_its_item(video, tmp_path):
    """closed_loop_enable, refused until the port had the loop, now runs
    it through the object Tracker while the Segmenter converts: the user
    module sees every frame with the JAX package's ids and positions."""
    root, src = video
    logs = {}
    for k, reset, seg_cls, kw in (("j", jax_reset, JaxSegmenter, {}),
                                  ("p", reset_global_settings,
                                   pipeline.Segmenter, {"device": "cpu"})):
        log = tmp_path / f"{k}.txt"
        module = tmp_path / f"{k}.py"
        module.write_text(
            "def update_tracking(data):\n"
            f"    open({str(log)!r}, 'a').write(\n"
            "        f'{data.frame} {data.ids.tolist()} "
            "{data.positions.tolist()}\\n')\n")
        s = apply(reset(), dict(CONVERT, closed_loop_enable=True,
                                closed_loop_path=str(module)))
        seg = seg_cls(s, src, tmp_path / f"cl_{k}.pv", **kw)
        tracker = seg.run()
        logs[k] = log.read_text().splitlines()
    assert type(tracker) is Tracker
    assert [int(line.split()[0]) for line in logs["p"]] == list(range(16))
    assert logs["p"] == logs["j"]


def _angles(tracker):
    return {fid: np.array([b.centroid.angle for b in ind.basic])
            for fid, ind in tracker.individuals.items()}


def test_object_and_fast_angles_depart_as_in_jax(tmp_path):
    """ROADMAP.md C5, a departure of the reference: through the track
    task the object Tracker takes a blob's orientation from its run sums
    and the FastTracker's archive from the labeler's moment sums, so
    their angles differ in the last bits. The port reproduces both
    engines' angles bit for bit, and so the same departure. The scene is
    chip_smoke.py phase 11's sparse chunk at a small size."""
    import chip_smoke

    _, frames = chip_smoke.synth_frames(12, n_fish=8, size=256)
    values = dict(chip_smoke.product_settings(8), detect_engine="host")
    pv = tmp_path / "s.pv"
    pipeline.Segmenter(apply(reset_global_settings(), values),
                       chip_smoke.array_source(frames), pv, track=False,
                       device="cpu").run()
    got, want = {}, {}
    for engine in ("object", "fast"):
        over = dict(values, track_engine=engine)
        want[engine] = JaxTrackingState(apply(jax_reset(), over), pv).run()
        got[engine] = pipeline.TrackingState(
            apply(reset_global_settings(), over), pv, device="cpu").run()
        _assert_individuals_equal(want[engine], got[engine])
    _assert_individuals_equal(got["object"], got["fast"], check_angle=False)
    jo, jf = _angles(want["object"]), _angles(want["fast"])
    po, pf = _angles(got["object"]), _angles(got["fast"])
    for fid in jo:
        np.testing.assert_array_equal(po[fid] - pf[fid], jo[fid] - jf[fid])
        assert np.abs(po[fid] - pf[fid]).max() < 1e-9
    assert any((po[fid] != pf[fid]).any() for fid in po)
