"""Visual fields (trex_tpu_torch/track/visual_field.py) against the JAX
package's (trex_tpu/track/visual_field.py): the outline tesselation and
the port's convex hull bit for bit (the hull against cv2.convexHull
under hypothesis), the tracker-level cases of tests/test_visual_field.py
with individuals built by each package's own classes from the same
arrays, and the CLI's -output_visual_fields export of
chip_smoke.synth_frames through both CLIs, every npz array equal, from
the object Tracker and from both fast engines' archives."""
import math

import cv2
import numpy as np
import pytest
from hypothesis import given, settings as hsettings, strategies as st

import chip_smoke
from test_torch_cli import _run
from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.cli import trex as jax_cli
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.track import visual_field as J
from trex_tpu_torch.cli import trex as port_cli
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.track import visual_field as T

PSEUDO = 4294967295 - 42


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def test_tesselate_outline_spacing():
    sq = np.array([[0, 0], [20, 0], [20, 20], [0, 20]], np.float32)
    t = T.tesselate_outline(sq, 5.0)
    np.testing.assert_array_equal(_bits(t), _bits(J.tesselate_outline(sq,
                                                                      5.0)))
    d = np.hypot(*np.diff(np.vstack([t, t[:1]]), axis=0).T)
    assert d.max() <= 5.0 + 1e-5
    assert len(t) >= 16


# coordinates from a small grid (collinear and duplicate points are
# common) or anywhere in float32's range of an arena
_coord = st.one_of(
    st.integers(-6, 6).map(float),
    st.floats(-2000, 2000, allow_nan=False, width=32))


@hsettings(max_examples=400, deadline=None)
@given(st.lists(st.tuples(_coord, _coord), min_size=1, max_size=40))
def test_convex_hull_equals_opencv(points):
    p = np.asarray(points, np.float32)
    want = cv2.convexHull(p)
    # no hull (two points equal but for a zero's sign) comes back as None
    want = np.zeros((0, 2), np.float32) if want is None \
        else want.reshape(-1, 2)
    got = T.convex_hull(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@hsettings(max_examples=300, deadline=None)
@given(st.lists(st.tuples(_coord, _coord), min_size=0, max_size=30),
       st.floats(0.05, 40.0), st.sampled_from([np.float32, np.float64]))
def test_tesselate_outline_equals_jax(points, max_distance, dtype):
    p = np.asarray(points, dtype).reshape(-1, 2)
    want = J.tesselate_outline(p, max_distance)
    got = T.tesselate_outline(p, max_distance)
    assert got.shape == np.asarray(want).shape
    if len(p) < 2:
        assert got is p and want is p
        return
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _tracker(pkg, fish):
    """A tracker of hand-built individuals in `pkg` ("jax" or "port"):
    per (fid, cx, angle) an 8x9 blob at (cx, 52), a head-first horizontal
    midline and a rectangular outline (tests/test_visual_field.py's)."""
    if pkg == "jax":
        from trex_tpu.track.blob import TrackBlob
        from trex_tpu.track.individual import (BasicStuff, Individual,
                                               PostureStuff)
        from trex_tpu.track.motion import MotionRecord
        from trex_tpu.track.posture import Midline
        s = jax_reset()
    else:
        from trex_tpu_torch.track.blob import TrackBlob
        from trex_tpu_torch.track.individual import (BasicStuff, Individual,
                                                     PostureStuff)
        from trex_tpu_torch.track.motion import MotionRecord
        from trex_tpu_torch.track.posture import Midline
        s = reset_global_settings()
    s.set("cm_per_pixel", 1.0)

    class _T:
        pass

    tracker = _T()
    tracker.individuals = {}
    for fid, cx, angle in fish:
        ind = Individual(fid, s)
        lines = np.array([[48 + r, cx - 4, cx + 4] for r in range(8)],
                         np.int32)
        blob = TrackBlob(lines, np.full(72, 80, np.uint8))
        rec = MotionRecord.create(None, 0.0, float(cx), 52.0, 0.0)
        ind._frames[0] = 0
        ind.basic.append(BasicStuff(frame=0, blob=blob, centroid=rec))
        segs = np.stack([np.linspace(cx + 3, cx - 3, 7), np.full(7, 4.0)],
                        axis=1)
        ml = Midline(segments=segs, heights=np.full(7, 4.0), len=6.0,
                     angle=angle)
        outline = np.array([[cx - 4, 48], [cx + 4, 48], [cx + 4, 55],
                            [cx - 4, 55]], np.float32)
        ind.add_posture(PostureStuff(frame=0, outline=outline, midline=ml))
        tracker.individuals[fid] = ind
    tracker.background = np.full((100, 100), 200, np.uint8)
    return tracker, s


def _fields_both(fish, **values):
    """compute_visual_fields of both packages on the same scene, held
    equal; returns the port's (ids, fields)."""
    jt, js = _tracker("jax", fish)
    pt, ps = _tracker("port", fish)
    for k, v in values.items():
        js.set(k, v)
        ps.set(k, v)
    want = J.compute_visual_fields(jt, 0, js)
    got = T.compute_visual_fields(pt, 0, ps, device="cpu")
    assert got[0] == want[0]
    assert sorted(got[1]) == sorted(want[1])
    for k, v in want[1].items():
        assert got[1][k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[1][k], v, err_msg=k)
    return got


def test_visual_field_sparse_fish_ids():
    """Fish ids need not be 0..F-1: the projection works on positional
    indexes and the id planes map back to real ids."""
    ids, fields = _fields_both([(5, 30, math.pi), (9, 70, 0.0)])
    assert ids == [5, 9]
    assert set(np.unique(fields["id0"])) <= {-1, 5, 9}
    assert 9 in set(np.unique(fields["id0"][0]))
    assert 5 in set(np.unique(fields["id0"][1]))


@pytest.mark.parametrize("shapes", [
    [[[60, 0], [64, 0], [64, 100], [60, 100]]],
    # the wall as a concave, repeated polygon and a second shape in fish
    # 5's view before the wall: both enter as their hulls, with pseudo-ids
    # 0 and 1
    [[[60, 0], [62, 50], [64, 0], [64, 100], [64, 100], [60, 100]],
     [[40, 20], [48, 20], [48, 30], [40, 30], [44, 25]]]])
def test_visual_field_shapes_occlude(shapes):
    """visual_field_shapes (VisualField.cpp:499-523): a user polygon
    between two fish blocks their line of sight and appears in the id
    plane with the reference's pseudo-id (uint32_max - 42 - j)."""
    fish = [(5, 30, math.pi), (9, 70, 0.0)]
    _, before = _fields_both(fish)
    bins_9_before = int((before["id0"][0] == 9).sum())
    assert bins_9_before > 0
    _, fields = _fields_both(fish, visual_field_shapes=shapes)
    plane = fields["id0"][0]
    wall = plane == PSEUDO
    assert wall.sum() > (plane == 9).sum()
    assert (plane == 9).sum() < bins_9_before / 2
    assert fields["depth0"][0][wall].min() <= 25.0
    if len(shapes) > 1:
        assert (fields["id0"] == PSEUDO - 1).any()


def test_too_many_individuals_raise_as_in_jax():
    fish = [(i, 10 + (i % 80), 0.0) for i in range(512)]
    pt, ps = _tracker("port", fish)
    jt, js = _tracker("jax", fish)
    with pytest.raises(ValueError, match="at most 511") as got:
        T.compute_visual_fields(pt, 0, ps, device="cpu")
    with pytest.raises(ValueError, match="at most 511"):
        J.compute_visual_fields(jt, 0, js)
    assert "got 512" in str(got.value)


SHAPES = "[[[100,20],[110,20],[110,120],[100,120]],[[20,200],[60,190],[40,230]]]"


@pytest.fixture(scope="module")
def synth_video(tmp_path_factory):
    """chip_smoke.synth_frames at a small size as a PNG sequence."""
    root = tmp_path_factory.mktemp("vf")
    _, frames = chip_smoke.synth_frames(10, n_fish=12, size=256, seed=1)
    (root / "vid").mkdir()
    for i, img in enumerate(frames):
        cv2.imwrite(str(root / "vid" / f"f_{i:03d}.png"), img)
    return root, str(root / "vid" / "f_%03d.png")


def test_export_equals_jax_cli(synth_video):
    """-output_visual_fields through both CLIs on the CPU: the registry's
    defaults track with the object Tracker, posture on, and every fish's
    visual-field npz holds the JAX CLI's arrays (and bytes)."""
    root, src = synth_video
    dirs = {}
    for k, cli, reset, kw in (("j", jax_cli, jax_reset, {}),
                              ("p", port_cli, reset_global_settings,
                               {"device": "cpu"})):
        out = root / k
        assert _run(cli, reset, [
            "-i", src, "-o", "vid", "-d", str(out), "-task", "convert",
            "-nowindow", "-average_samples", "5", "-meta_encoding", "gray",
            "-averaging_method", "max"], **kw) == 0
        assert _run(cli, reset, [
            "-i", str(out / "vid.pv"), "-d", str(out / "t"), "-task",
            "track", "-nowindow", "-auto_quit", "-output_visual_fields",
            "true", "-visual_field_shapes", SHAPES], **kw) == 0
        dirs[k] = sorted((out / "t" / "data").glob("*_visual_field_*.npz"))
    names = [p.name for p in dirs["j"]]
    assert names == [p.name for p in dirs["p"]] and len(names) >= 8
    seen_shape = False
    for a, b in zip(dirs["j"], dirs["p"]):
        with np.load(a) as want, np.load(b) as got:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                assert got[k].dtype == want[k].dtype, (a.name, k)
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{a.name} {k}")
            assert len(want["frames"]) >= 5
            seen_shape |= bool((want["id0"] >= PSEUDO - 1).any())
        assert a.read_bytes() == b.read_bytes(), a.name
    assert seen_shape


@pytest.mark.parametrize("engine", ["fast", "device"])
def test_export_from_the_fast_engines_equals_jax(synth_video, engine):
    """The FastTracker's and the DeviceTracker's archived individuals
    (the port's on the CPU) give the visual fields through the same
    posture_stuff/basic_stuff API: the JAX CLI's files, byte for byte."""
    root, src = synth_video
    dirs = {}
    for k, cli, reset, kw in (("j", jax_cli, jax_reset, {}),
                              ("p", port_cli, reset_global_settings,
                               {"device": "cpu"})):
        out = root / f"{engine}_{k}"
        assert _run(cli, reset, [
            "-i", src, "-o", "vid", "-d", str(out), "-task", "convert",
            "-nowindow", "-average_samples", "5", "-meta_encoding", "gray",
            "-averaging_method", "max", "-track_threshold", "20",
            "-track_background_subtraction", "true",
            "-track_max_individuals", "12", "-track_max_speed", "300",
            "-cm_per_pixel", "1", "-frame_rate", "25",
            "-track_size_filter", "[[20,400]]"], **kw) == 0
        assert _run(cli, reset, [
            "-i", str(out / "vid.pv"), "-d", str(out / "t"), "-task",
            "track", "-nowindow", "-auto_quit", "-track_engine", engine,
            "-output_visual_fields", "true"], **kw) == 0
        dirs[k] = sorted((out / "t" / "data").glob("*_visual_field_*.npz"))
    assert [p.name for p in dirs["p"]] == [p.name for p in dirs["j"]]
    assert len(dirs["j"]) >= 8
    for a, b in zip(dirs["j"], dirs["p"]):
        assert a.read_bytes() == b.read_bytes(), a.name
