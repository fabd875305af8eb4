"""Posture from pose keypoints and from detection outlines: the port's
trex_tpu_torch/track/posture.py against the JAX package's, and the track
task of both CLIs on .pv files whose blobs carry such predictions.

- `generate_outline_from_pose` (circles along the skeleton, filled as
  OpenCV fills them, the biggest component traced), `reduce_vertex_line`
  and `_ensure_circle_overlap` equal the JAX functions' output on seeded
  keypoints, invalid (0, 0) points and midline orders included;
- `calculate_posture_from_pose` and `calculate_posture_from_outline` on
  the blobs of `chip_smoke.synth_scene` with their fish's keypoints
  (`chip_smoke.stamp_keypoints`) and their own outlines: outlines,
  midline segments, heights, indexes, length and angle equal, bit for
  bit;
- `trex -task track -auto_quit` on `chip_smoke.prediction_pv` files
  (pose and outline predictions) under the object Tracker and the
  FastTracker (whose per-row python posture takes the same precedence,
  `track/archive.py::posture_python_row`) writes the JAX CLI's npz and
  .results bytes on the CPU, the posture coming from the predictions.
  The object Tracker keeps a blob's prediction only where its prefilter
  does not threshold the blob, as the JAX package's does
  (`track_threshold` 0, the registry's default; ROADMAP.md C7)."""
import shutil

import numpy as np
import pytest

import chip_smoke
from test_torch_cli import _assert_trees_equal, _run
from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.cli import trex as jax_cli
from trex_tpu.config import Settings as JaxSettings
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.track import posture as jax_posture
from trex_tpu.track.blob import TrackBlob as JaxBlob
from trex_tpu_torch.cli import trex as port_cli
from trex_tpu_torch.config import Settings, reset_global_settings
from trex_tpu_torch.config import write_settings_file
from trex_tpu_torch.ops.labeling import label_blobs
from trex_tpu_torch.track import posture
from trex_tpu_torch.track.blob import TrackBlob

N_FISH, N_FRAMES, SIZE = 8, 16, 256


def assert_posture_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert np.array_equal(a.outline, b.outline)
    assert tuple(a.offset) == tuple(b.offset)
    assert (a.midline is None) == (b.midline is None)
    if a.midline is not None:
        for f in ("segments", "heights"):
            x, y = getattr(a.midline, f), getattr(b.midline, f)
            assert np.array_equal(x, y), f
        for f in ("tail_index", "head_index", "len", "angle",
                  "inverted_because_previous"):
            assert getattr(a.midline, f) == getattr(b.midline, f), f


@pytest.mark.parametrize("seed", range(6))
def test_outline_from_pose_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    pts = rng.uniform(-20, 60, (n, 2)).round(int(rng.integers(0, 3)))
    pts[rng.random(n) < 0.2] = 0.0  # invalid points
    for order in ([], list(range(n)), [n - 1, 0, 1, 7, -1]):
        for radius_map in (None, lambda t: 6.0 * (1 - t) + 1.0):
            got = posture.generate_outline_from_pose(pts, order, radius_map)
            want = jax_posture.generate_outline_from_pose(pts, order,
                                                          radius_map)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want)
    c, r = [tuple(p) for p in pts], list(rng.uniform(1, 9, n))
    c2, r2 = list(c), list(r)
    posture._ensure_circle_overlap(c, r)
    jax_posture._ensure_circle_overlap(c2, r2)
    assert c == c2 and r == r2
    line = rng.uniform(0, 50, (30, 2)).astype(np.float32)
    for eps in (0.0, 0.5, 3.0):
        assert np.array_equal(posture.reduce_vertex_line(line, eps),
                              jax_posture.reduce_vertex_line(line, eps))


@pytest.fixture(scope="module")
def scene():
    return chip_smoke.synth_scene(N_FRAMES, n_fish=N_FISH, size=SIZE,
                                  seed=4)


def _values():
    return chip_smoke.pose_settings(N_FISH, 20)


def _pair(values):
    j, p = JaxSettings(), Settings()
    for k, v in values.items():
        j.set(k, v)
        p.set(k, v)
    return j, p


@pytest.mark.parametrize("compression", [0.0, 1.5])
def test_posture_from_pose_and_outline_equal_jax(scene, compression):
    bg, frames, track = scene
    values = dict(_values(), outline_compression=compression)
    j, p = _pair(values)
    sizes = np.array([(13 + k % 5, 8 + k % 3) for k in range(N_FISH)])
    n = 0
    for f in (0, 7, 15):
        centres = np.floor(track[f]) + sizes / 2
        for b in label_blobs(frames[f], bg, 20, False):
            lines = np.asarray(b.lines, np.int32)
            pb, jb = TrackBlob(lines, b.pixels), JaxBlob(lines, b.pixels)
            x0, y0, w, h = pb.bounds
            k = np.flatnonzero((centres[:, 0] >= x0)
                               & (centres[:, 0] <= x0 + w)
                               & (centres[:, 1] >= y0)
                               & (centres[:, 1] <= y0 + h))
            if not len(k):
                continue
            kp = chip_smoke.stamp_keypoints(track[f, k[0]], int(k[0]))
            for direction in (None, np.array([1.0, 0.2])):
                assert_posture_equal(
                    posture.calculate_posture_from_pose(
                        pb, kp, p, movement_direction=direction),
                    jax_posture.calculate_posture_from_pose(
                        jb, kp, j, movement_direction=direction))
            dense = np.zeros((h, w), np.uint8)
            for y, a, e in lines:
                dense[y - y0, a - x0:e - x0 + 1] = 1
            outline = (posture.trace_boundary(dense)
                       + np.array([x0, y0])).round().astype(np.int32)
            for flat in (outline, outline.ravel()):
                assert_posture_equal(
                    posture.calculate_posture_from_outline(pb, flat, p),
                    jax_posture.calculate_posture_from_outline(jb, flat, j))
            n += 1
    assert n >= 12


@pytest.fixture(scope="module")
def prediction_pvs(scene, tmp_path_factory):
    bg, frames, track = scene
    root = tmp_path_factory.mktemp("pred")
    out = {}
    for kind in ("pose", "outline"):
        pv = root / kind / "vid.pv"
        pv.parent.mkdir()
        n = chip_smoke.prediction_pv(pv, bg, frames, track, kind, _values())
        assert n >= N_FISH * N_FRAMES * 0.8
        out[kind] = pv
    settings = {}
    # the object Tracker keeps predictions where it does not threshold
    # the blob (track_threshold 0, the registry's); the fast engines
    # need a threshold
    for engine, threshold in (("object", 0), ("fast", 20)):
        settings[engine] = root / f"{engine}.settings"
        s = reset_global_settings()
        for k, v in chip_smoke.pose_settings(N_FISH, threshold).items():
            s.set(k, v)
        write_settings_file(s, settings[engine])
    reset_global_settings()
    return out, settings


@pytest.mark.parametrize("engine", ["object", "fast"])
@pytest.mark.parametrize("kind", ["pose", "outline"])
def test_track_task_on_prediction_pv_writes_the_jax_cli_files(
        prediction_pvs, tmp_path, monkeypatch, kind, engine):
    import trex_tpu_torch.pipeline as pipeline
    import trex_tpu_torch.track.archive as archive

    pvs, settings = prediction_pvs
    settings = settings[engine]
    calls = {}
    name = f"calculate_posture_from_{kind}"
    for mod in (pipeline, archive):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, **k):
            calls[kind] = calls.get(kind, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    dirs = {}
    for side, cli, reset, kw in (("j", jax_cli, jax_reset, {}),
                                 ("p", port_cli, reset_global_settings,
                                  {"device": "cpu"})):
        d = tmp_path / side
        d.mkdir()
        pv = d / "vid.pv"
        shutil.copy(pvs[kind], pv)
        argv = ["-i", str(pv), "-d", str(d / "t"), "-s", str(settings),
                "-task", "track", "-nowindow", "-auto_quit",
                "-track_engine", engine, "-output_posture_data", "true"]
        assert _run(cli, reset, argv, **kw) == 0
        dirs[side] = d
    want = _assert_trees_equal(dirs["j"], dirs["p"])
    postures = [k for k in want if "_posture_" in k]
    assert "vid.results" in want and len(postures) >= N_FISH
    # the port's posture came from the predictions
    assert calls.get(kind, 0) >= N_FISH * N_FRAMES * 0.8
