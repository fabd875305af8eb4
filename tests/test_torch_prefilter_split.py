"""The object Tracker's host stages against their JAX twins on the same
blobs: ``prefilter`` (size filters, the threshold re-split, shape
filters, track_ignore_bdx, track_threshold_2, tags), ``HistorySplit``
(``split_expectation`` and ``apply``), ``split_scan_py`` (the numpy
scan, also held to the native ``split_scan``) and ``compute_caches``.
Blob ids, pixel counts, split flags, filter reasons and expectations
are exact; recounts and caches are float64 and equal bit for bit
(tolerance 0)."""
import importlib

import numpy as np
import pytest

import chip_smoke
from test_engine import _synth
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.pipeline import detect_frame as jax_detect_frame
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.individual import Individual as JaxIndividual
from trex_tpu.track.tracker import Tracker as JaxTracker
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ops.labeling import split_scan
from trex_tpu_torch.track import cache_batch, prefilter, splitting
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.individual import Individual

from test_torch_tracker import ENGINE, apply, both_settings

# trex_tpu.track re-exports functions under these modules' names
jax_cache_batch = importlib.import_module("trex_tpu.track.cache_batch")
jax_prefilter = importlib.import_module("trex_tpu.track.prefilter")
jax_splitting = importlib.import_module("trex_tpu.track.splitting")


def _frames(values, n_frames=6, n_fish=24, size=192, seed=0):
    bg, frames = chip_smoke.synth_frames(n_frames, n_fish=n_fish, size=size,
                                         seed=seed)
    js = apply(jax_reset(), values)
    raw = [[(b.lines, b.pixels, b.flags) for b in jax_detect_frame(f, bg, js)]
           for f in frames]
    return bg, raw


def _pair(raw):
    return ([JaxTrackBlob(l, p, flags=f) for l, p, f in raw],
            [TrackBlob(l, p, flags=f) for l, p, f in raw])


def _summary(blobs):
    return [(b.blob_id, b.num_pixels, b.split, b.parent_id,
             b.recount(-1) if b._last_recount is not None else None)
            for b in blobs]


@pytest.mark.parametrize("over", [
    {},                                                   # registry
    dict(ENGINE),
    dict(ENGINE, track_size_filter=[[20, 60], [80, 400]]),
    dict(ENGINE, track_threshold=60),                     # re-split
    dict(ENGINE, track_threshold_2=80),
    dict(ENGINE, track_ignore=[[[0, 0], [96, 0], [96, 96], [0, 96]]],
         track_include=[[[0, 0], [192, 140]]]),
    dict(track_size_filter=[[5, 30]], cm_per_pixel=0.5),  # big blobs
])
def test_prefilter_equals_jax(over):
    values = dict(over)
    bg, raw = _frames(values)
    js, ps = both_settings(values)
    flags_seen = 0
    for i, fr in enumerate(raw):
        if i == 2 and fr:   # a tag blob, dropped under tags_dont_track
            l, p, f = fr[0]
            fr = [(l, p, f | 0x2)] + fr[1:]
        if i == 3:
            bdx = {"3": [JaxTrackBlob(*fr[1][:2]).blob_id]}
            js.set("track_ignore_bdx", bdx)
            ps.set("track_ignore_bdx", bdx)
        jb, pb = _pair(fr)
        ref = jax_prefilter.prefilter(i, jb, bg, js)
        got = prefilter.prefilter(i, pb, bg, ps)
        assert _summary(got.filtered) == _summary(ref.filtered), i
        assert _summary(got.big_blobs) == _summary(ref.big_blobs), i
        assert [(b.blob_id, r.name) for b, r in got.filtered_out] \
            == [(b.blob_id, r.name) for b, r in ref.filtered_out], i
        assert got.frame_index == ref.frame_index
        flags_seen += len(got.filtered_out)
    assert flags_seen > 0 or not over


def _history_scene(seed):
    """The dense scene of tests/test_archive.py tracked by the JAX
    object Tracker to frame k; its estimated positions and frame k+1's
    prefiltered blobs feed the history split."""
    values = dict(ENGINE, track_max_individuals=32)
    bg, frames = _synth(16, 32, 256, seed)
    js = apply(jax_reset(), values)
    tr = JaxTracker(js, background=bg)
    cases = []
    for i, f in enumerate(frames):
        raw = [(b.lines, b.pixels, b.flags)
               for b in jax_detect_frame(f, bg, js)]
        pp = tr.preprocess_frame(i, [JaxTrackBlob(l, p, flags=fl)
                                     for l, p, fl in raw], time=i / 25)
        if i:
            active = tr._active_individuals()
            caches = jax_cache_batch.compute_caches(
                active, i, i / 25, tr.frame_times, tr.start_frame, js)
            pos = [caches[ind.identity].estimated_px for ind in active
                   if not caches[ind.identity].individual_empty]
            cases.append((i, raw, pp, pos))
        tr.add(pp)
    return values, bg, cases


@pytest.mark.parametrize("seed", [1, 2])
def test_history_split_equals_jax(seed):
    values, bg, cases = _history_scene(seed)
    js, ps = both_settings(values)
    n_split = 0
    for i, raw, _, pos in cases:
        jb = jax_prefilter.prefilter(i, _pair(raw)[0], bg, js).filtered
        pb = prefilter.prefilter(i, _pair(raw)[1], bg, ps).filtered
        jh, ph = jax_splitting.HistorySplit(js), splitting.HistorySplit(ps)
        max_d = 300 / 25 * 0.5
        assert ph.split_expectation(pb, pos, max_d) \
            == jh.split_expectation(jb, pos, max_d), i
        jn, pn = [], []
        ref = jh.apply(i, jb, pos, bg, jn)
        got = ph.apply(i, pb, pos, bg, pn)
        assert _summary(got) == _summary(ref), i
        assert _summary(pn) == _summary(jn), i
        n_split += sum(b.split and b.parent_id != b.blob_id for b in got)
    assert n_split > 0


def test_manual_split_forces_two_pieces():
    from test_torch_engine import render

    frame = render([[80, 100], [88, 100]], core=True)
    bg = np.full(frame.shape, 200, np.uint8)
    values = dict(ENGINE, track_size_filter=[[10, 200]],
                  detect_threshold=15, detect_threshold_is_absolute=False)
    raw = [(b.lines, b.pixels, b.flags)
           for b in jax_detect_frame(frame, bg, apply(jax_reset(), values))]
    bid = JaxTrackBlob(*raw[0][:2]).blob_id
    values["manual_splits"] = {"5": [bid]}
    js, ps = both_settings(values)
    jb, pb = _pair(raw)
    ref = jax_splitting.HistorySplit(js).apply(5, jb, [], bg, [])
    got = splitting.HistorySplit(ps).apply(5, pb, [], bg, [])
    assert _summary(got) == _summary(ref) and len(got) == 2


def test_split_scan_py_equals_jax_and_native():
    from test_torch_engine import render

    values = dict(ENGINE, track_size_filter=[[10, 90]])
    js, ps = both_settings(values)
    n_keep = 0
    for gap in range(0, 10, 2):
        frame = render([[80, 100], [88 + gap, 100], [84, 104]], core=True)
        bg = np.full(frame.shape, 200, np.uint8)
        for b in jax_detect_frame(frame, bg, apply(jax_reset(), dict(
                values, detect_threshold=15,
                detect_threshold_is_absolute=False))):
            tb = TrackBlob(b.lines, b.pixels)
            img, bgc = splitting._split_crop(tb, bg)
            for expected in (2, 3):
                ref = jax_splitting.split_scan_py(img, bgc, 21, False,
                                                  expected, js)
                got = splitting.split_scan_py(img, bgc, 21, False,
                                              expected, ps)
                assert got == ref
                assert got == split_scan(img, bgc, 21, False, expected, 1.0,
                                         0.2, 0.2, [[10, 90]])
                n_keep += got[0] >= 0
    assert n_keep > 0


def test_compute_caches_equals_jax():
    """Caches over fish with a manual frame (scalar path), fresh fish,
    long-lost fish and windows with frame gaps, at several query
    frames; the vectorized path equals the scalar cache_for_frame."""
    values = dict(ENGINE, track_speed_decay=0.7)
    js, ps = both_settings(values)
    rng = np.random.default_rng(7)
    jf, pf, times = [], [], {}
    for fid in range(12):
        a, b = JaxIndividual(fid, js), Individual(fid, ps)
        f = int(rng.integers(0, 4))
        x, y = rng.uniform(20, 200, 2)
        while f < 40:
            times[f] = f / 25
            lines = np.array([[int(y) + r, int(x), int(x) + 8]
                              for r in range(5)], np.int32)
            px = np.full(45, 90, np.uint8)
            manual = fid == 3 and f == 10
            a.add(f, f / 25, JaxTrackBlob(lines, px), prob=0.9,
                  manual=manual)
            b.add(f, f / 25, TrackBlob(lines, px), prob=0.9, manual=manual)
            x += rng.normal(0, 3)
            y += rng.normal(0, 3)
            f += int(rng.choice([1, 1, 1, 2, 5], p=[.6, .1, .1, .1, .1]))
            if fid == 5 and f > 20:
                break       # lost: tdelta beyond track_max_reassign_time
        jf.append(a)
        pf.append(b)
    for f in range(41):
        times.setdefault(f, f / 25)
    for frame in (20, 38, 41):
        ref = jax_cache_batch.compute_caches(
            [i for i in jf if i.end_frame < frame], frame, frame / 25,
            times, 0, js)
        got = cache_batch.compute_caches(
            [i for i in pf if i.end_frame < frame], frame, frame / 25,
            times, 0, ps)
        assert sorted(got) == sorted(ref)
        for fid in ref:
            assert vars(got[fid]) == vars(ref[fid]), (frame, fid)
