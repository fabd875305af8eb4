"""The port's tag detection (trex_tpu_torch/track/tags.py) against the
JAX package's (trex_tpu/track/tags.py) on the same blobs: the crops,
variances, shape test, detect_tags with and without settings and a
decoder, the Hungarian matching and the tags_path NPZ. Tolerance 0: the
port's image routines are bit-for-bit copies of the OpenCV routines the
JAX package calls (tests/test_torch_tag_image.py). Also: the CPU tag
path with cv2 and h5py blocked."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import trex_tpu.track.tags as J
import trex_tpu_torch.track.tags as T
from test_torch_tracker import TRACKING, blob_at, both_settings, detected
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.tracker import Tracker as JaxTracker
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.tracker import Tracker

REPO = Path(__file__).resolve().parents[1]


def _random_blob(rng, h, w, x0=40, y0=30):
    """(lines, pixels) of a random blob inside an (h, w) box: a tag-like
    checker of two grey levels with noise, each row one run that keeps
    at least one pixel."""
    lines, px = [], []
    cell = max(1, int(rng.integers(1, 4)))
    yy, xx = np.indices((h, w))
    img = np.where(((yy // cell + xx // cell) % 2) == 0,
                   rng.integers(0, 60), rng.integers(120, 250))
    img = np.clip(img + rng.normal(0, 8, (h, w)), 0, 255).astype(np.uint8)
    for r in range(h):
        a = int(rng.integers(0, max(1, w // 4)))
        b = int(w - 1 - rng.integers(0, max(1, w // 4)))
        b = max(a, b)
        lines.append([y0 + r, x0 + a, x0 + b])
        px.append(img[r, a:b + 1])
    return np.array(lines, np.int32), np.concatenate(px)


def _blob_pairs(rng, sides):
    out = []
    for s in sides:
        h = int(s)
        w = int(max(1, s - rng.integers(0, max(1, s // 3) + 1)))
        lines, px = _random_blob(rng, h, w)
        out.append((JaxTrackBlob(lines, px), TrackBlob(lines, px)))
    return out


def _tags_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.variance, x.blob_id, x.frame, x.tag_id, x.p, x.center) \
            == (y.variance, y.blob_id, y.frame, y.tag_id, y.p, y.center)
        assert x.image.dtype == y.image.dtype == np.uint8
        assert x.image.tobytes() == y.image.tobytes()
        assert x.mask.tobytes() == y.mask.tobytes()


@pytest.mark.parametrize("max_size", [None, [80, 80], [20, 12]])
def test_prettify_blobs_equals_jax(max_size):
    """Squares of every side from 1 to 96 (the three resize regimes) and
    the tags_maximum_image_size centre crop."""
    rng = np.random.default_rng(0)
    pairs = _blob_pairs(rng, range(1, 97))
    bg = np.full((200, 200), 200, np.uint8)
    want = J.prettify_blobs([a for a, _ in pairs], bg, max_size=max_size)
    got = T.prettify_blobs([b for _, b in pairs], bg, max_size=max_size)
    _tags_equal(want, got)


def test_is_good_image_equals_jax():
    rng = np.random.default_rng(1)
    for _ in range(50):
        grey = rng.integers(0, 256, (32, 32), np.uint8)
        mask = (rng.random((32, 32)) < rng.uniform(0.2, 1.0)
                ).astype(np.uint8) * 255
        a, b = J.is_good_image(grey, mask), T.is_good_image(grey, mask)
        assert a.variance == b.variance


@pytest.mark.parametrize("threshold,equalize,sides,approx", [
    (-5, False, [3, 7], 0.025), (5, False, [4, 4], 0.025),
    (-12, True, [3, 7], 0.05), (0, True, [5, 9], None)])
def test_shape_test_equals_jax(threshold, equalize, sides, approx):
    """_tag_shape_ok over the tag scene's crops and random crops, with
    either threshold type, equalization and other side ranges."""
    js, ps = both_settings(dict(tags_threshold=threshold,
                                tags_equalize_hist=equalize,
                                tags_num_sides=sides,
                                tags_approximation=approx))
    rng = np.random.default_rng(2)
    pairs = _blob_pairs(rng, rng.integers(4, 40, 60))
    bg, frames, values = _tag_frames()
    for lines, px, flags in detected(frames[:2], bg, values)[1]:
        pairs.append((JaxTrackBlob(lines, px), TrackBlob(lines, px)))
    want = J.prettify_blobs([a for a, _ in pairs], bg)
    got = T.prettify_blobs([b for _, b in pairs], bg)
    hits = [J._tag_shape_ok(t, js) for t in want]
    assert [T._tag_shape_ok(t, ps) for t in got] == hits
    assert 0 < sum(hits) < len(hits) or threshold > 0


def _tag_frames(n_fish=8, n_frames=4):
    ids = [(37 * k + 11) % 256 for k in range(n_fish)]
    bg, frames, _ = chip_smoke.synth_scene(
        n_frames, n_fish=n_fish, size=256, seed=1,
        codes=[chip_smoke.tag_code(t) for t in ids])
    values = dict(TRACKING, cm_per_pixel=0.1, track_size_filter=[[0.4, 10]],
                  track_threshold=20, detect_threshold=20)
    return bg, frames, values


class _Decoder:
    """A per-image decoder returning (id, p) from the crop's bytes."""

    def __call__(self, img):
        h = int(np.asarray(img, np.int64).sum())
        return h % 256, (h % 97) / 97.0


@pytest.mark.parametrize("with_settings", [False, True])
@pytest.mark.parametrize("decoder", [None, "tuple", "bare"])
def test_detect_tags_equals_jax(with_settings, decoder):
    rng = np.random.default_rng(3)
    bg, frames, values = _tag_frames()
    raw = detected(frames[:1], bg, values)[0]
    pairs = [(JaxTrackBlob(l, p), TrackBlob(l, p)) for l, p, _ in raw]
    pairs += _blob_pairs(rng, rng.integers(2, 30, 20))
    js, ps = both_settings(dict(values, tags_debug=True))
    fn = {None: None, "tuple": _Decoder(),
          "bare": lambda img: int(np.asarray(img).max())}[decoder]
    kw = dict(min_variance=50.0, decode_fn=fn)
    want = J.detect_tags([a for a, _ in pairs], bg, 7,
                         settings=js if with_settings else None, **kw)
    stats = {}
    got = T.detect_tags([b for _, b in pairs], bg, 7,
                        settings=ps if with_settings else None,
                        stats=stats, **kw)
    _tags_equal(want, got)
    assert len(got) > 0
    assert stats["frames"] == 1 and stats["shape"] == len(got)
    assert stats["decoded"] == (len(got) if fn else 0)
    assert set(stats) == set(T.STAT_KEYS)
    assert stats["host_s"] >= 0 and stats["decode_s"] >= 0


def test_detect_tags_batch_decoder_equals_per_image():
    """A decoder with a batch form decodes the frame's tags in one call,
    with the per-image calls' ids and p."""
    calls = []

    class Batched(_Decoder):
        def batch(self, images):
            calls.append(len(images))
            got = [self(i) for i in images]
            return [g[0] for g in got], [g[1] for g in got]

    bg, frames, values = _tag_frames()
    raw = detected(frames[:1], bg, values)[0]
    blobs = [TrackBlob(l, p) for l, p, _ in raw]
    _, ps = both_settings(values)
    one = T.detect_tags(blobs, bg, 0, decode_fn=_Decoder(), settings=ps)
    many = T.detect_tags(blobs, bg, 0, decode_fn=Batched(), settings=ps)
    _tags_equal(one, many)
    assert calls == [len(many)]


def test_aux_detection_and_matching_case():
    """tests/test_aux.py::test_tags_detection_and_matching through both
    packages: a sharp checkerboard near the fish, a flat noise blob."""
    js, ps = both_settings(TRACKING)
    bg = np.full((100, 100), 200, np.uint8)
    ref, got = JaxTracker(js, background=bg), Tracker(ps, background=bg,
                                                      device="cpu")
    lines, px, _ = blob_at(20, 20, value=100)
    ref.add(ref.preprocess_frame(0, [JaxTrackBlob(lines, px)], 0.0))
    got.add(got.preprocess_frame(0, [TrackBlob(lines, px)], 0.0))
    lines = np.array([[40 + r, 30, 37] for r in range(8)], np.int32)
    tag_px = (np.indices((8, 8)).sum(0) % 2 * 255).astype(np.uint8
                                                          ).reshape(-1)
    flat_px = np.full(64, 120, np.uint8)
    want = J.detect_tags([JaxTrackBlob(lines, tag_px),
                          JaxTrackBlob(lines + 30, flat_px)], bg, frame=0,
                         min_variance=500.0)
    tags = T.detect_tags([TrackBlob(lines, tag_px),
                          TrackBlob(lines + 30, flat_px)], bg, frame=0,
                         min_variance=500.0)
    _tags_equal(want, tags)
    assert len(tags) == 1
    mw = J.match_tags_to_fish(want, ref, 0, max_distance=100)
    mg = T.match_tags_to_fish(tags, got, 0, max_distance=100)
    assert 0 in mg and mg.keys() == mw.keys()
    assert mg[0].blob_id == mw[0].blob_id


def test_match_and_save_equal_jax(tmp_path):
    """The Hungarian matching over a tagged scene's frames (ties, tags
    out of reach) and the tags_path NPZ."""
    bg, frames, values = _tag_frames(n_frames=6)
    values = dict(values, tags_enable=True)
    raw = detected(frames, bg, values)
    js, ps = both_settings(values)
    ref = JaxTracker(js, background=bg)
    got = Tracker(ps, background=bg, device="cpu")
    for i, r in enumerate(raw):
        rp = ref.preprocess_frame(i, [JaxTrackBlob(l, p, flags=f)
                                      for l, p, f in r], i / 25)
        gp = got.preprocess_frame(i, [TrackBlob(l, p, flags=f)
                                      for l, p, f in r], i / 25)
        ref.add(rp)
        got.add(gp)
        jt = J.detect_tags(rp.noise, bg, i, settings=js)
        gt = T.detect_tags(gp.noise, bg, i, settings=ps)
        _tags_equal(jt, gt)
        for dist in (80.0, 5.0):
            mw = J.match_tags_to_fish(jt, ref, i, max_distance=dist)
            mg = T.match_tags_to_fish(gt, got, i, max_distance=dist)
            assert {k: v.blob_id for k, v in mw.items()} \
                == {k: v.blob_id for k, v in mg.items()}
    assert got.detected_tags
    J.save_tags(tmp_path / "j" / "tags.npz", ref.detected_tags)
    T.save_tags(tmp_path / "p" / "tags.npz", got.detected_tags)
    with np.load(tmp_path / "j" / "tags.npz") as a, \
            np.load(tmp_path / "p" / "tags.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


_BLOCKED = """
import sys
sys.modules["cv2"] = None
sys.modules["h5py"] = None
sys.modules["jax"] = None
import numpy as np
import chip_smoke
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ml.tagwork import TagDecoderNet, save_keras_sequential_h5
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.tracker import Tracker
from trex_tpu_torch.ops.labeling import label_blobs
path = sys.argv[1]
save_keras_sequential_h5(path, TagDecoderNet(256, 32, seed=1,
                                             device="cpu").layer_specs())
ids = [(37 * k + 11) % 256 for k in range(6)]
bg, frames, _ = chip_smoke.synth_scene(
    3, n_fish=6, size=256, seed=1,
    codes=[chip_smoke.tag_code(t) for t in ids])
s = reset_global_settings()
for k, v in dict(cm_per_pixel=0.1, track_size_filter=[[0.4, 10.0]],
                 track_threshold=20, track_background_subtraction=True,
                 tags_recognize=True, tags_model_path=path,
                 tags_image_size=[32, 32]).items():
    s.set(k, v)
tr = Tracker(s, background=bg, device="cpu")
for i, f in enumerate(frames):
    blobs = [TrackBlob(b.lines, b.pixels)
             for b in label_blobs(f, bg, threshold=20)]
    tr.add(tr.preprocess_frame(i, blobs, i / 25))
n = sum(len(v) for v in tr.tag_assignments.values())
bad = [m for m in ("cv2", "h5py", "jax") if sys.modules.get(m)]
print(n, tr.tag_decoder.images, bad)
"""


def test_cpu_tag_path_runs_without_cv2_or_h5py(tmp_path):
    """The tag path on the CPU (crops, gates, the decoder from an .h5
    the port writes) with cv2, h5py and jax blocked in sys.modules."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _BLOCKED,
                        str(tmp_path / "t.h5")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    n, images, bad = r.stdout.strip().split(" ", 2)
    assert int(n) > 0 and int(images) >= int(n) and bad == "[]"
