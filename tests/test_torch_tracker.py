"""The port's object Tracker (trex_tpu_torch/track/tracker.py) against
the JAX package's (trex_tpu/track/tracker.py), frame by frame on the
same blobs. Integers are exact: the prefiltered, noise and big blob ids,
the first pass's pairings, identities, the frames and blob ids of every
individual, `number_fish` and `match_improvements`. The float64
positions, velocities, tracklets, the caches of `compute_caches` and
`Individual.cache_for_frame` and the probabilities are equal bit for bit
(tolerance 0): both run the same numpy code on the same values.

Scenes: those of tests/test_tracking.py (two fish, the
track_max_individuals cap, the long gap, the recent-samples gap, the
trusted-probability break, the huge timestamp), a synth_frames chunk
under the registry's defaults, manual matches and splits, the shape
filters, track_threshold_2, categories, match_topk, the start-frame big
split, history splits, and match_mode=benchmark with its report."""
import numpy as np
import pytest

import chip_smoke
from test_archive import _assert_individuals_equal
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.ml.categorize import DataStore as JaxDataStore
from trex_tpu.pipeline import detect_frame as jax_detect_frame
from trex_tpu.track import matching as jax_matching
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.cache_batch import compute_caches as jax_compute_caches
from trex_tpu.track.individual import Individual as JaxIndividual
from trex_tpu.track.tracker import Tracker as JaxTracker
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ml.categorize import DataStore
from trex_tpu_torch.track import matching
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.cache_batch import compute_caches
from trex_tpu_torch.track.engine import EngineUnsupported
from trex_tpu_torch.track.individual import Individual
from trex_tpu_torch.track.tracker import FrameStatistics, Tracker

# tests/test_tracking.py::_settings
TRACKING = dict(frame_rate=25, track_max_speed=800, cm_per_pixel=1.0,
                track_threshold=12, track_threshold_is_absolute=False,
                track_background_subtraction=True,
                track_size_filter=[[10, 500]], track_max_individuals=8)
# tests/test_engine.py::_settings (product default matching)
ENGINE = dict(track_max_speed=300, cm_per_pixel=1.0, frame_rate=25,
              track_threshold=20, track_threshold_is_absolute=False,
              track_background_subtraction=True,
              track_size_filter=[[20, 400]], calculate_posture=False,
              match_mode="automatic")


def apply(s, values):
    for k, v in values.items():
        s.set(k, v)
    return s


def both_settings(values):
    return apply(jax_reset(), values), apply(reset_global_settings(), values)


def blob_at(x, y, w=6, h=6, value=30):
    """tests/test_tracking.py::_blob_at as (lines, pixels, flags)."""
    lines = np.array([[y + r, x, x + w - 1] for r in range(h)], np.int32)
    return lines, np.full(w * h, value, np.uint8), 0


def detected(frames, bg, values):
    """Per frame the (lines, pixels, flags) of the JAX package's
    background-subtraction detection."""
    js = apply(jax_reset(), values)
    return [[(b.lines, b.pixels, b.flags)
             for b in jax_detect_frame(f, bg, js)] for f in frames]


def _ids(blobs):
    return [(b.blob_id, b.num_pixels, b.split, b.parent_id) for b in blobs]


def assert_caches_equal(ref: dict, got: dict):
    assert sorted(ref) == sorted(got)
    for fid in ref:
        assert vars(ref[fid]) == vars(got[fid]), fid


def assert_trackers_equal(ref, got, frame_time):
    """Identities, per-individual archives bit for bit, the tracker's
    bookkeeping, and the caches and probabilities of the next frame."""
    _assert_individuals_equal(ref, got)
    assert ref.active == got.active and ref._next_id == got._next_id
    assert (ref.start_frame, ref.end_frame) == (got.start_frame,
                                                got.end_frame)
    assert ref.frame_times == got.frame_times
    for fid, a in ref.individuals.items():
        b = got.individuals[fid]
        assert a.manual_frames == b.manual_frames
        assert a._win.tobytes() == b._win.tobytes()
        for x, y in zip(a.basic, b.basic):
            assert vars(x.centroid) == vars(y.centroid)
            assert x.thresholded_size == y.thresholded_size
    nxt = ref.end_frame + 1
    t = frame_time(nxt)
    active_r = ref._active_individuals()
    active_g = got._active_individuals()
    assert [i.identity for i in active_r] == [i.identity for i in active_g]
    ref_c = jax_compute_caches(active_r, nxt, t, ref.frame_times,
                               ref.start_frame, ref.settings)
    got_c = compute_caches(active_g, nxt, t, got.frame_times,
                           got.start_frame, got.settings)
    assert_caches_equal(ref_c, got_c)
    for a, b in zip(active_r, active_g):
        ca = a.cache_for_frame(nxt, t, ref.frame_times, ref.start_frame)
        cb = b.cache_for_frame(nxt, t, got.frame_times, got.start_frame)
        assert vars(ca) == vars(cb)
        for pos in ((10.0, 20.0), ca.estimated_px, (300.5, 7.25)):
            assert a.probability(ca, pos) == b.probability(cb, pos)
        assert a.recent_number_samples(nxt) == b.recent_number_samples(nxt)
        va = a.calculate_previous_vector(a.end_frame, 5)
        vb = b.calculate_previous_vector(b.end_frame, 5)
        assert (va is None and vb is None) or np.array_equal(va, vb)


def drive(values, frames, bg, times=None, setup=None):
    """Both trackers over `frames` (lists of (lines, pixels, flags));
    returns them after holding every frame's integers equal."""
    js, ps = both_settings(values)
    ref, got = JaxTracker(js, background=bg), Tracker(ps, background=bg)
    if setup is not None:
        setup(ref, got)

    def frame_time(i):
        return times[i] if times is not None else i / 25.0

    for i, raw in enumerate(frames):
        t = frame_time(i)
        rp = ref.preprocess_frame(
            i, [JaxTrackBlob(l, p, flags=f) for l, p, f in raw], time=t)
        gp = got.preprocess_frame(
            i, [TrackBlob(l, p, flags=f) for l, p, f in raw], time=t)
        assert _ids(rp.blobs) == _ids(gp.blobs), i
        assert _ids(rp.noise) == _ids(gp.noise), i
        assert _ids(rp.big) == _ids(gp.big), i
        rr, gr = ref.add(rp), got.add(gp)
        assert gr.pairings == rr.pairings, i
        assert gr.improvements_made == rr.improvements_made, i
        assert _ids(rp.blobs) == _ids(gp.blobs), i   # after the splits
        assert _ids(rp.noise) == _ids(gp.noise), i
        a, b = ref.statistics[i], got.statistics[i]
        assert (a.number_fish, a.match_improvements) \
            == (b.number_fish, b.match_improvements), i
    if frames:
        assert_trackers_equal(ref, got, frame_time)
    return ref, got


def test_two_fish():
    bg = np.full((200, 200), 200, np.uint8)
    frames = [[blob_at(10 + 5 * f, 20, value=100),
               blob_at(150 - 5 * f, 120, value=100)] for f in range(10)]
    ref, got = drive(TRACKING, frames, bg)
    assert len(got.individuals) == 2
    assert all(len(i.tracklets) == 1 for i in got.individuals.values())


def test_max_individuals_cap():
    bg = np.full((200, 200), 200, np.uint8)
    frames = [[blob_at(10, 10, value=100), blob_at(50, 50, value=100),
               blob_at(100, 100, value=100), blob_at(150, 150, value=100)]]
    _, got = drive(dict(TRACKING, track_max_individuals=2), frames, bg)
    assert len(got.individuals) == 2


def test_long_gap_and_reactivation():
    """tests/test_tracking.py::test_long_gap_fish_gated_from_first_pass:
    the fish lost for 11 frames is neither matched nor reactivated at
    frame 12 and reactivates by distance at frame 14."""
    bg = np.full((400, 200), 200, np.uint8)
    frames = [[blob_at(20, 20, value=100), blob_at(20, 120, value=100)]]
    frames += [[blob_at(20 + 2 * f, 20, value=100)] for f in range(1, 12)]
    frames += [[blob_at(44, 20, value=100), blob_at(80, 120, value=100)],
               [blob_at(46, 20, value=100)],
               [blob_at(48, 20, value=100), blob_at(80, 120, value=100)]]
    _, got = drive(dict(TRACKING, track_max_individuals=2,
                        track_do_history_split=False), frames, bg)
    lost = [i for i in got.individuals.values() if not i.has(11)][0]
    assert not lost.has(12) and lost.has(14)


@pytest.mark.parametrize("scene", ["recent_gap", "trusted", "huge_time"])
def test_individual_tracklets_and_caches(scene):
    """The Individual scenes of tests/test_tracking.py through both
    packages' Individual.add: tracklets, recent samples, caches and
    probabilities bit for bit."""
    over = {"recent_gap": {},
            "trusted": dict(track_trusted_probability=0.5),
            "huge_time": dict(tracklet_punish_timedelta=True,
                              huge_timestamp_seconds=0.2)}[scene]
    js, ps = both_settings(dict(TRACKING, **over))
    ref, got = JaxIndividual(0, js), Individual(0, ps)
    if scene == "recent_gap":
        steps = [(f, f / 25, -1.0) for f in list(range(21))
                 + list(range(33, 37))]
    elif scene == "trusted":
        steps = [(0, 0.0, 0.9), (1, 0.04, 0.9), (2, 0.08, 0.9),
                 (3, 0.12, 0.3), (4, 0.16, -1.0)]
    else:
        steps = [(0, 0.0, 0.9), (1, 0.04, 0.9), (2, 0.5, 0.9)]
    times = {}
    for f, t, p in steps:
        times[f] = t
        l, px, _ = blob_at(10 + f, 10, value=100)
        ref.add(f, t, JaxTrackBlob(l, px), prob=p)
        got.add(f, t, TrackBlob(l, px), prob=p)
        assert got.tracklets == ref.tracklets
    nxt = steps[-1][0] + 1
    assert got.recent_number_samples(nxt) == ref.recent_number_samples(nxt)
    ca = ref.cache_for_frame(nxt, nxt / 25, times, start_frame=0)
    cb = got.cache_for_frame(nxt, nxt / 25, times, start_frame=0)
    assert vars(ca) == vars(cb)
    assert got.probability(cb, (12.0, 13.0)) \
        == ref.probability(ca, (12.0, 13.0))
    assert len(got.tracklets) == {"recent_gap": 2, "trusted": 2,
                                  "huge_time": 2}[scene]


def _synth_chunk(n_fish=24, size=256, n_frames=16, seed=0):
    bg, frames = chip_smoke.synth_frames(n_frames, n_fish=n_fish, size=size,
                                         seed=seed)
    return bg, list(frames)


def test_registry_defaults_on_a_synth_chunk():
    """A user's unchanged settings (track_threshold 0, no background
    subtraction, unlimited speed, automatic matching), which both fast
    engines refuse."""
    bg, frames = _synth_chunk()
    values = dict(cm_per_pixel=1.0, frame_rate=25)
    raw = detected(frames, bg, values)
    _, got = drive(values, raw, bg)
    assert 20 <= len(got.individuals) <= 24


@pytest.mark.parametrize("seed", [1, 2])
def test_history_splits_on_a_dense_chunk(seed):
    """tests/test_archive.py's dense scene (32 fish at 256^2): fish
    cross and the history split divides their blobs."""
    from test_engine import _synth

    bg, frames = _synth(24, 32, 256, seed)
    values = dict(ENGINE, track_max_individuals=32)
    ref, got = drive(values, detected(frames, bg, values), bg)
    assert any(b.blob.split for i in got.individuals.values()
               for b in i.basic)


def test_manual_matches_and_splits():
    bg = np.full((200, 200), 200, np.uint8)
    frames = [[blob_at(10 + 5 * f, 20, value=100),
               blob_at(150 - 5 * f, 120, value=100)] for f in range(8)]
    bid = {f: [JaxTrackBlob(l, p).blob_id for l, p, _ in fr]
           for f, fr in enumerate(frames)}
    manual = {3: {"0": bid[3][1], "1": bid[3][0]}, "5": {"4": bid[5][0]}}
    # a merged pair at frame 6 that manual_splits forces apart
    merged = np.zeros((200, 200), np.uint8)
    merged[:] = 200
    merged[60:66, 40:60] = 120
    merged[61:65, 42:48] = 60
    merged[61:65, 52:58] = 60
    frames[6] = frames[6] + [
        (b.lines, b.pixels, b.flags) for b in jax_detect_frame(
            merged, bg, apply(jax_reset(), dict(
                TRACKING, detect_threshold=20,
                detect_threshold_is_absolute=False)))]
    split_bid = JaxTrackBlob(*frames[6][2][:2]).blob_id
    values = dict(TRACKING, manual_matches=manual,
                  manual_splits={6: [split_bid]},
                  track_size_filter=[[10, 500]])
    _, got = drive(values, frames, bg)
    assert got.individuals[4].has(5) and 5 in got.individuals[4].manual_frames
    assert got.individuals[0].basic_stuff(3).blob.blob_id == bid[3][1]
    assert any(b.blob.split for i in got.individuals.values()
               for b in i.basic if b.frame == 6)


@pytest.mark.parametrize("filters", [
    dict(track_ignore=[[[0, 0], [100, 0], [100, 60], [0, 60]]]),
    dict(track_include=[[[0, 80], [200, 200]]]),
    dict(track_ignore_bdx={"2": [], 4: []}),
    dict(track_threshold_2=60, threshold_ratio_range=[0.5, 1.0])])
def test_shape_filters_and_second_threshold(filters):
    bg = np.full((200, 200), 200, np.uint8)
    frames = [[blob_at(10 + 5 * f, 20, value=100),
               blob_at(150 - 5 * f, 120, value=100),
               blob_at(60, 150, value=170)] for f in range(8)]
    if "track_ignore_bdx" in filters:
        l, p, _ = frames[2][1]
        filters = dict(track_ignore_bdx={
            "2": [JaxTrackBlob(l, p).blob_id],
            4: [JaxTrackBlob(*frames[4][0][:2]).blob_id]})
    drive(dict(TRACKING, **filters), frames, bg)


def test_consistent_categories():
    """Two fish that swap sides; the category store labels each blob
    by its fish, and the veto keeps identities on their category."""
    bg = np.full((200, 200), 200, np.uint8)
    frames, labels = [], []
    for f in range(12):
        a = blob_at(20 + 12 * f, 50 + f, value=100)
        b = blob_at(152 - 12 * f, 56 - f, value=100)
        frames.append([a, b])
        labels.append([(JaxTrackBlob(*a[:2]).blob_id, "a"),
                       (JaxTrackBlob(*b[:2]).blob_id, "b")])

    def setup(ref, got):
        ref.category_store = JaxDataStore(["a", "b"])
        got.category_store = DataStore(["a", "b"])
        for f, lab in enumerate(labels):
            for bid, name in lab:
                ref.category_store.set_blob_label(f, bid, name)
                got.category_store.set_blob_label(f, bid, name)

    values = dict(TRACKING, track_consistent_categories=True,
                  track_max_speed=3000, track_max_individuals=2)
    _, got = drive(values, frames, bg, setup=setup)
    assert len(got.individuals) == 2


def test_match_topk():
    bg, frames = _synth_chunk(n_fish=16, size=160, n_frames=10, seed=3)
    values = dict(ENGINE, track_max_individuals=16, match_topk=2,
                  track_max_speed=3000)
    drive(values, detected(frames, bg, values), bg)


def test_start_frame_big_split():
    """tests/test_torch_engine.py::scene_start_merged: a pair merged at
    frame 0 is split by threshold escalation at the start frame."""
    from test_torch_engine import render

    frames = [render([[80 - f, 100], [88 + f, 100]], core=True)
              for f in range(12)]
    bg = np.full(frames[0].shape, 200, np.uint8)
    values = dict(ENGINE, track_max_individuals=2, track_size_filter=[[10, 90]],
                  match_mode="approximate")
    raw = detected(frames, bg, dict(values, detect_threshold=15,
                                    detect_threshold_is_absolute=False))
    _, got = drive(values, raw, bg)
    assert len(got.individuals) == 2
    assert all(i.has(0) for i in got.individuals.values())


def test_match_mode_benchmark_and_report(capsys):
    """match_mode=benchmark: the hungarian assignment, the disagreement
    warnings and the report's lines (names and sample counts; the times
    are the wall clock's)."""
    bg, frames = _synth_chunk(n_fish=16, size=160, n_frames=8, seed=4)
    values = dict(ENGINE, track_max_individuals=16, track_max_speed=3000,
                  match_mode="benchmark")
    raw = detected(frames, bg, values)
    jax_matching.reset_benchmarks()
    matching.reset_benchmarks()
    capsys.readouterr()
    js, ps = both_settings(values)
    for tracker_cls, s, blob_cls in ((JaxTracker, js, JaxTrackBlob),
                                     (Tracker, ps, TrackBlob)):
        tr = tracker_cls(s, background=bg)
        for i, fr in enumerate(raw):
            tr.add(tr.preprocess_frame(
                i, [blob_cls(l, p, flags=f) for l, p, f in fr],
                time=i / 25))
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:]
    drive(values, raw, bg)

    def shape(report):
        return [(line.split(":")[0], line.split("(")[1])
                for line in report]
    assert shape(matching.benchmark_report()) \
        == shape(jax_matching.benchmark_report())
    assert [k for k, v in sorted(matching.BENCHMARKS.items())] \
        == ["approximate", "hungarian", "tree"]
    jax_matching.reset_benchmarks()
    matching.reset_benchmarks()


def test_frame_statistics_has_every_field():
    assert list(vars(FrameStatistics())) == [
        "number_fish", "adding_seconds", "loading_seconds",
        "posture_seconds", "match_improvements"]


def test_tags_raise_naming_their_item():
    s = apply(reset_global_settings(), dict(tags_enable=True))
    with pytest.raises(EngineUnsupported, match="A item 3"):
        Tracker(s)
