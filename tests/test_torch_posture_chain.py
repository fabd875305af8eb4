"""Port parity of the host posture chain per blob and of the batch chain
with full geometry (``trex_tpu_torch/track/posture.py``) against the JAX
package's ``trex_tpu/track/posture.py``, on the blobs of the asymmetric
posture scene (``chip_smoke.asym_scene``) and of the dense synthetic
scene of ``tests/test_engine.py``.

Rule: no tolerance. Both packages run the same float64/float32 numpy and
the byte-equal native sources, so traces, resampled outlines, walks,
midline segments, heights, indices, lengths and angles are bit-equal,
through the native chain and through the numpy chain
(``_force_python_chain`` set in both packages)."""
import numpy as np
import pytest

from trex_tpu.config import reset_global_settings
from trex_tpu.ops.labeling import label_blobs as jax_label_blobs
from trex_tpu.track import archive as JA
from trex_tpu.track import posture as JP
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu_torch.ops.labeling import label_blobs
from trex_tpu_torch.track import archive as TA
from trex_tpu_torch.track import posture as TP
from trex_tpu_torch.track.blob import TrackBlob

import chip_smoke
from test_engine import _synth
from test_torch_engine import as_dict, one_torch_thread  # noqa: F401


def _scene(name):
    """(background, frames, JAX settings, port settings)."""
    if name == "asym":
        bg, frames, d = chip_smoke.asym_scene()
    else:
        bg, frames = _synth(6, 24, 256, 4)
        frames = np.stack(frames)
        d = dict(chip_smoke.posture_settings(chip_smoke.track_settings(24)),
                 outline_resample=0.5)
    s = reset_global_settings()
    for k, v in d.items():
        s.set(k, v)
    return bg, frames, s, as_dict(s)


def _blob_pairs(bg, frames, n_frames=6):
    det = dict(threshold=15, absolute=True, track_threshold=20,
               track_absolute=False)
    out = []
    for img in frames[:n_frames]:
        jb = jax_label_blobs(img, bg, **det)
        tb = label_blobs(img, bg, **det)
        assert len(jb) == len(tb)
        out += [(JaxTrackBlob(a.lines, a.pixels, stats=a.stats),
                 TrackBlob(b.lines, b.pixels, stats=b.stats))
                for a, b in zip(jb, tb)]
    return out


def _assert_result_equal(r, g):
    assert (r is None) == (g is None)
    if r is None:
        return 0
    assert r.offset == g.offset
    np.testing.assert_array_equal(g.outline, r.outline)
    assert (r.midline is None) == (g.midline is None)
    if r.midline is None:
        return 0
    a, b = r.midline, g.midline
    np.testing.assert_array_equal(b.segments, a.segments)
    np.testing.assert_array_equal(b.heights, a.heights)
    assert (b.tail_index, b.head_index, b.inverted_because_previous) \
        == (a.tail_index, a.head_index, a.inverted_because_previous)
    assert b.len == a.len and b.angle == a.angle
    return 1


@pytest.fixture(params=[False, True], ids=["native", "python"])
def chain_route(request, monkeypatch):
    monkeypatch.setattr(JP, "_force_python_chain", request.param)
    monkeypatch.setattr(TP, "_force_python_chain", request.param)
    return request.param


@pytest.mark.parametrize("name", ["asym", "synth"])
def test_calculate_posture_equals_jax(name, chain_route):
    bg, frames, s, d = _scene(name)
    n_mid = 0
    for k, (jb, tb) in enumerate(_blob_pairs(bg, frames)):
        direction = None if k % 3 == 0 else np.array(
            [np.cos(k), np.sin(k)])
        ref = JP.calculate_posture(jb, s, bg, movement_direction=direction)
        got = TP.calculate_posture(tb, d, bg, movement_direction=direction)
        n_mid += _assert_result_equal(ref, got)
    assert n_mid >= 20


@pytest.mark.parametrize("name", ["asym", "synth"])
def test_chain_steps_equal_jax(name):
    """trace_boundary (and its numpy twin), resample (and its numpy twin),
    _midline_walk (and its numpy twin) per blob."""
    bg, frames, s, d = _scene(name)
    for jb, tb in _blob_pairs(bg, frames, 3):
        jd, _ = JP.biggest_component(jb, 15, bg, s)
        td, _ = TP.biggest_component(tb, 15, bg, d)
        np.testing.assert_array_equal(td, jd)
        mask = np.kron(td, np.ones((4, 4), np.uint8))
        trace = TP.trace_boundary(mask)
        np.testing.assert_array_equal(trace, JP.trace_boundary(mask))
        np.testing.assert_array_equal(TP._trace_boundary_py(mask), trace)
        pts = trace / 4.0
        res = TP.resample(pts, 0.5)
        np.testing.assert_array_equal(res, JP.resample(pts, 0.5))
        np.testing.assert_array_equal(TP._resample_py(pts, 0.5), res)
        L = len(res)
        walk = TP._midline_walk(np.ascontiguousarray(res), max(3, L // 40))
        np.testing.assert_array_equal(
            walk, JP._midline_walk(np.ascontiguousarray(res),
                                   max(3, L // 40)))
        np.testing.assert_allclose(
            TP._midline_walk_py(res, max(3, L // 40)), walk, rtol=0,
            atol=1e-5)


@pytest.mark.parametrize("name", ["asym", "synth"])
def test_posture_batch_full_equals_jax(name):
    bg, frames, s, d = _scene(name)
    pairs = _blob_pairs(bg, frames, 4)
    lines = [np.asarray(t.lines, np.int32) for _, t in pairs]
    pixels = [t.pixels for _, t in pairs]
    rng = np.random.default_rng(0)
    md = rng.normal(0, 1, (len(pairs), 2))
    md[::3] = 0.0
    ref = JP.posture_batch_full(lines, pixels, bg, s, movement_dirs=md)
    got = TP.posture_batch_full(lines, pixels, bg, d, movement_dirs=md)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["ok"].sum() >= len(pairs) // 2
    # a small outline capacity truncates rows, which the records take
    # through the per-blob chain
    ref = JP.posture_batch_full(lines, pixels, bg, s, movement_dirs=md,
                                outline_cap=64, seg_cap=8)
    got = TP.posture_batch_full(lines, pixels, bg, d, movement_dirs=md,
                                outline_cap=64, seg_cap=8)
    assert got["trunc"].any()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", ["asym", "synth"])
def test_compute_posture_rows_records_equal_jax(name, chain_route):
    """The records of one frame's rows (native rows, and rows the
    python chain redoes) with their crop offsets, byte-equal."""
    bg, frames, s, d = _scene(name)
    pairs = _blob_pairs(bg, frames, 1)
    lines = [np.asarray(t.lines, np.int32) for _, t in pairs]
    pixels = [t.pixels for _, t in pairs]
    md = np.zeros((len(pairs), 2))
    md[1::2] = [0.6, 0.8]
    ref = JA.compute_posture_rows(s, bg, lines, pixels, None, md,
                                  want_recs=True)
    got = TA.compute_posture_rows(d, bg, lines, pixels, None, md,
                                  want_recs=True)
    for a, b in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(got[5], ref[5])
    n = 0
    for a, b in zip(ref[4], got[4]):
        assert (a is None) == (b is None)
        if a is None:
            continue
        n += 1
        for k in ("outline", "seg", "heights"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
        assert (a.tail, a.head, a.inverted, a.off, a.len_px, a.angle) \
            == (b.tail, b.head, b.inverted, b.off, b.len_px, b.angle)
    assert n >= len(pairs) // 2


def test_pose_and_outline_predictions_raise_naming_the_yolo_slice():
    """Pose and outline predictions, which raised until the YOLO slice,
    give the JAX package's posture through the per-row python path."""
    bg, frames, s, d = _scene("asym")
    jb, tb = _blob_pairs(bg, frames, 1)[0]
    x, y, w, h = tb.bounds
    kp = np.stack([np.linspace(x, x + w - 1, 5), np.full(5, y + h / 2)], 1)
    dense = np.zeros((h, w), np.uint8)
    for yy, a, b in tb.lines:
        dense[yy - y, a - x:b - x + 1] = 1
    outline = (TP.trace_boundary(dense) + np.array([x, y])).astype(np.int32)
    for pred in ({"keypoints": kp}, {"original_outline": outline.ravel()}):
        got = TA.posture_python_row(d, bg, tb.lines, tb.pixels, pred, None)
        want = JA.posture_python_row(s, bg, jb.lines, jb.pixels, pred, None)
        assert got is not None and got.midline is not None
        assert np.array_equal(got.outline, want.outline)
        assert np.array_equal(got.midline.segments, want.midline.segments)
        assert got.midline.len == want.midline.len
    # closing steps run now (tests/test_torch_posture_closing.py holds
    # them to OpenCV and the JAX package)
    dense, _ = TP.biggest_component(tb, 15, bg, d, closing_steps=1)
    assert dense is not None and dense.any()
