"""Port parity: the port's host labeler (``trex_tpu_torch/native``, built
with g++ at first use) and the host split helpers against the JAX
package's ``ops/labeling.py`` and ``track/`` on synthetic frames. Arrays
must be byte-equal."""
import importlib

import numpy as np
import pytest

from trex_tpu.config import reset_global_settings
from trex_tpu.ops import labeling as JL
from trex_tpu.track import blob as JB
from trex_tpu.track import splitting as JS
from trex_tpu_torch.config import DEFAULTS
from trex_tpu_torch.ops import labeling as TL
from trex_tpu_torch.track import blob as TB
from trex_tpu_torch.track import prefilter as TP
from trex_tpu_torch.track import splitting as TS

# trex_tpu.track exports a function named prefilter over its module
JP = importlib.import_module("trex_tpu.track.prefilter")


def _frame(seed, size=(96, 128)):
    """Dark rectangles of several shades on a bright background, some of
    them touching, with a few pixels of value 0 inside."""
    rng = np.random.default_rng(seed)
    bg = np.full(size, 200, np.uint8)
    bg[:, : size[1] // 2] = 190
    img = bg.copy()
    for _ in range(14):
        y, x = rng.integers(0, size[0] - 8), rng.integers(0, size[1] - 12)
        h, w = rng.integers(2, 9), rng.integers(2, 13)
        img[y:y + h, x:x + w] = rng.integers(40, 185)
    img[rng.integers(0, size[0], 5), rng.integers(0, size[1], 5)] = 0
    return img, bg


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kw", [
    dict(threshold=15, absolute=True, track_threshold=20,
         track_absolute=False),
    dict(threshold=25, absolute=False),
    dict(threshold=0),
])
def test_label_blobs_raw_and_label_blobs(seed, kw):
    img, bg = _frame(seed)
    background = bg
    if kw["threshold"] == 0:
        # components of the nonzero pixels
        img, background = np.where(img != bg, img, 0).astype(np.uint8), None
    ref = JL.label_blobs_raw(img, background, **kw)
    got = TL.label_blobs_raw(img, background, **kw)
    assert set(got) == set(ref)
    for k in ref:
        _assert_same(got[k], ref[k])
    assert len(ref["stats"]) > 3
    ref_b = JL.label_blobs(img, background, **kw)
    got_b = TL.label_blobs(img, background, **kw)
    assert len(got_b) == len(ref_b)
    for g, r in zip(got_b, ref_b):
        for k in ("lines", "pixels", "stats"):
            _assert_same(getattr(g, k), getattr(r, k))


def _merged_blob(seed):
    """One blob at threshold 15 whose darker cores separate at higher
    thresholds: two fish-sized cores joined by a pale bridge."""
    rng = np.random.default_rng(seed)
    bg = np.full((64, 96), 200, np.uint8)
    img = bg.copy()
    img[20:28, 10:40] = 180
    img[21:27, 12:24] = rng.integers(60, 90)
    img[21:27, 27:38] = rng.integers(60, 90)
    return img, bg


@pytest.mark.parametrize("seed", [3, 4])
def test_threshold_blob_split_scan_and_sizes(seed):
    img, bg = _merged_blob(seed)
    blobs = JL.label_blobs(img, bg, threshold=15, absolute=False)
    assert len(blobs) == 1
    b = blobs[0]
    for thr in (16, 40, 150):
        ref = JL.threshold_blob_native(b.lines, b.pixels, bg, thr, False)
        got = TL.threshold_blob_native(b.lines, b.pixels, bg, thr, False)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            for k in ("lines", "pixels", "stats"):
                _assert_same(getattr(g, k), getattr(r, k))
    crop = img[15:33, 5:45]
    bg_crop = bg[15:33, 5:45]
    thrs = np.arange(16, 256)
    for absolute in (True, False):
        _assert_same(TL.split_sizes(crop, bg_crop, thrs, absolute),
                     JL.split_sizes(crop, bg_crop, thrs, absolute))
    for expected, ranges in ((2, [(10.0, 90.0)]), (3, [(10.0, 90.0)]),
                             (2, [])):
        args = (crop, bg_crop, 16, False, expected, 1.0, 0.2, 0.2, ranges)
        assert TL.split_scan(*args) == JL.split_scan(*args)


def _settings():
    s = reset_global_settings()
    s.set("track_threshold", 20)
    s.set("track_threshold_is_absolute", False)
    s.set("track_background_subtraction", True)
    s.set("track_size_filter", [[10, 90]])
    s.set("calculate_posture", False)
    return s


@pytest.mark.parametrize("seed", [3, 4])
def test_track_blob_threshold_components_and_split(seed):
    img, bg = _merged_blob(seed)
    s = _settings()
    d = {k: s[k] for k in DEFAULTS}
    b = JL.label_blobs(img, bg, threshold=15, absolute=False)[0]
    jb = JB.TrackBlob(b.lines, b.pixels, stats=b.stats)
    tb = TB.TrackBlob(b.lines, b.pixels, stats=b.stats)
    assert tb.blob_id == jb.blob_id == JB.blob_id_from_lines(b.lines)
    assert tb.bounds == jb.bounds and tb.center == jb.center
    for pad in (0, 1):
        for g, r in zip(tb.to_dense(pad)[:2], jb.to_dense(pad)[:2]):
            _assert_same(g, r)
    assert tb.recount(20, bg, d) == jb.recount(20, bg, s)
    assert TS._initial_threshold(d) == JS._initial_threshold(s)
    for thr in (20, 100):
        ref = JP.threshold_components(
            JB.TrackBlob(b.lines, b.pixels, stats=b.stats), thr, bg, s)
        got = TP.threshold_components(
            TB.TrackBlob(b.lines, b.pixels, stats=b.stats), thr, bg, d)
        assert [(g.blob_id, g.num_pixels, g._recount_cache.get(thr))
                for g in got] == [(r.blob_id, r.num_pixels,
                                   r._recount_cache.get(thr)) for r in ref]
    for want in (2, 3):
        ref = JS.split_blob(jb, want, bg, s)
        got = TS.split_blob(tb, want, bg, d)
        assert [(g.blob_id, g.num_pixels, g.center, g.recount(-1))
                for g in got] == [(r.blob_id, r.num_pixels, r.center,
                                   r.recount(-1)) for r in ref]
    assert len(TS.split_blob(tb, 2, bg, d)) == 2
    # a blob without pixel data labels its dense crop
    no_px = TP.threshold_components(TB.TrackBlob(b.lines, None), 20, bg, d)
    ref = JP.threshold_components(JB.TrackBlob(b.lines, None), 20, bg, s)
    assert [g.lines.tobytes() for g in no_px] \
        == [r.lines.tobytes() for r in ref]


def test_size_filters():
    for ranges in ([], [[10, 45], [100, 400]], [[5, 20]]):
        j, t = JP.SizeFilters(ranges), TP.SizeFilters(ranges)
        assert bool(j) == bool(t) and j.max_range == t.max_range
        for v in (4.0, 10.0, 50.0, 400.0, 401.0):
            assert j.in_range_of_one(v) == t.in_range_of_one(v)


def test_blob_stats_equal_labeler_stats():
    img, bg = _frame(5)
    raw = TL.label_blobs_raw(img, bg, threshold=15, track_threshold=20,
                             track_absolute=False)
    stats = TL.blob_stats(raw["lines"], raw["line_start"], raw["pixels"],
                          raw["pixel_start"], bg, 20, False)
    _assert_same(stats, raw["stats"])


def test_library_is_the_ports_own_build():
    path = TL.build()
    assert path.parent == TL.BUILD_DIR
    assert path.name.startswith("libtrexlabel_")
    assert TL._lib()._name == str(path)
    assert (TL.NATIVE / "labeling.cpp").is_file()
    assert "trex_tpu/" not in str(TL.NATIVE) + str(path)


def test_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(TL, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        TL.build()


def test_failed_build_raises(monkeypatch, tmp_path):
    src = tmp_path / "native"
    src.mkdir()
    (src / "labeling.cpp").write_text("int broken(;\n")
    for name in TL.SOURCES[1:] + TL.HEADERS:
        (src / name).write_text("")
    monkeypatch.setattr(TL, "NATIVE", src)
    monkeypatch.setattr(TL, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        TL.build()
    assert not list((tmp_path / "build").glob("*.so"))
