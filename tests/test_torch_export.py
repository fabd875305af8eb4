"""The port's export and .results (trex_tpu_torch/export/) against the
JAX package's on the same tracked .pv: export_data (CSV and NPZ, the
default output_fields with BORDER_DISTANCE, and every field of the
library), export_posture, save_results (binary and npz) and
load_results of the golden V_39 file. Files compare byte for byte;
loaded records compare with ==."""
from pathlib import Path
from types import SimpleNamespace

import cv2
import numpy as np
import pytest

from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.export import export as jax_export
from trex_tpu.export import library as jax_library
from trex_tpu.export import results as jax_results
from trex_tpu.pipeline import TrackingState as JaxTrackingState
from trex_tpu_torch import pipeline
from trex_tpu_torch.config import Settings, reset_global_settings
from trex_tpu_torch.export import export as port_export
from trex_tpu_torch.export import results as port_results

GOLDEN = Path(__file__).parent / "data" / "golden_v39.results"
DEFAULT = Settings()

TRACK = dict(track_max_individuals=6, track_max_speed=300, cm_per_pixel=0.5,
             frame_rate=25, track_threshold=20,
             track_threshold_is_absolute=False,
             track_background_subtraction=True,
             track_size_filter=[[5, 200]], calculate_posture=True,
             outline_resample=0.5, match_mode="automatic",
             detect_threshold=15, detect_threshold_is_absolute=False,
             meta_encoding="gray", averaging_method="max")


def _apply(s, values):
    for k, v in values.items():
        s.set(k, v)
    return s


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    """Six fish over 24 frames at 160^2 (two of them cross), converted
    by the port, then tracked by the JAX FastTracker and by the port's
    FastTracker and DeviceTracker (plain path)."""
    root = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(7)
    pos = rng.uniform(20, 130, (6, 2))
    vel = rng.normal(0, 2.0, (6, 2))
    pos[1] = pos[0] + [40, 0]
    vel[1] = [-1.8, 0.2]
    vel[0] = [1.5, 0.0]
    (root / "frames").mkdir()
    for i in range(24):
        img = np.full((160, 160), 200, np.uint8)
        for k, (x, y) in enumerate(pos):
            xi, yi = int(x), int(y)
            img[yi:yi + 6, xi:xi + 12] = 80
            img[yi + 1:yi + 5, xi + 9:xi + 12] = 40 + 10 * k
        cv2.imwrite(str(root / "frames" / f"f_{i:03d}.png"), img)
        pos = np.clip(pos + vel, 5, 140)
    s = _apply(reset_global_settings(), TRACK)
    pipeline.Segmenter(s, str(root / "frames" / "f_%03d.png"),
                       root / "v.pv", track=False, device="cpu").run()
    ref_s = _apply(jax_reset(), dict(TRACK, track_engine="fast"))
    ref_state = JaxTrackingState(ref_s, root / "v.pv")
    out = {"jax": (ref_state.run(), ref_s, ref_state.pv)}
    for engine in ("fast", "device"):
        s = _apply(reset_global_settings(), dict(TRACK, track_engine=engine))
        state = pipeline.TrackingState(s, root / "v.pv", device="cpu")
        out[engine] = (state.run(), s, state.pv)
    yield root, out
    for tracker, _, pv in out.values():
        pv.close()


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def _export_pair(root, out, engine, tag, fn, **over):
    ref_tracker, ref_s, ref_pv = out["jax"]
    tracker, s, pv = out[engine]
    for k, v in over.items():
        ref_s.set(k, v)
        s.set(k, v)
    try:
        fn(jax_export, ref_tracker, ref_s, root / f"{tag}_jax", ref_pv)
        fn(port_export, tracker, s, root / f"{tag}_{engine}", pv)
    finally:
        for k in over:
            default = DEFAULT[k]
            ref_s.set(k, default)
            s.set(k, default)
    want = _files(root / f"{tag}_jax")
    assert want
    assert _files(root / f"{tag}_{engine}") == want


def _data(mod, tracker, s, d, pv):
    mod.export_data(tracker, s, d, "v", pv_file=pv)


@pytest.mark.parametrize("engine", ["fast", "device"])
@pytest.mark.parametrize("fmt", ["csv", "npz"])
def test_export_data_default_fields_equal_jax(tracked, engine, fmt):
    root, out = tracked
    assert ["BORDER_DISTANCE", ["PCENTROID"]] in out[engine][1][
        "output_fields"]
    _export_pair(root, out, engine, f"data_{fmt}", _data,
                 output_format=fmt)


def test_export_data_every_field_equals_jax(tracked):
    """Every field of the library's FUNCTIONS table, with each centroid
    source, as CSV with 6 decimals."""
    from trex_tpu_torch.export import library

    assert sorted(library.FUNCTIONS) == sorted(jax_library.FUNCTIONS)
    fields = []
    for name in sorted(library.FUNCTIONS):
        fields.append([name, ["RAW"]])
        if name in ("X", "Y", "SPEED", "ACCELERATION", "VX", "AX"):
            fields += [[name, ["RAW", src]] for src in
                       ("WCENTROID", "PCENTROID", "HEAD", "SMOOTH")]
    root, out = tracked
    _export_pair(root, out, "fast", "every", _data, output_fields=fields,
                 output_format="csv", output_csv_decimals=6,
                 output_interpolate_positions=True)


def _posture(mod, tracker, s, d, pv):
    mod.export_posture(tracker, s, d, "v")


@pytest.mark.parametrize("engine", ["fast", "device"])
@pytest.mark.parametrize("normalize", [False, True])
def test_export_posture_equals_jax(tracked, engine, normalize):
    root, out = tracked
    _export_pair(root, out, engine, f"posture_{normalize}", _posture,
                 output_normalize_midline_data=normalize)


@pytest.mark.parametrize("engine", ["fast", "device"])
@pytest.mark.parametrize("fmt", ["binary", "npz"])
def test_save_results_equals_jax(tracked, engine, fmt):
    root, out = tracked
    ref_tracker, ref_s, _ = out["jax"]
    tracker, s, _ = out[engine]
    a = port_results.save_results(tracker, s,
                                  root / f"{engine}_{fmt}.results", fmt)
    # the settings text records track_engine: name the same engine
    ref_s.set("track_engine", engine)
    try:
        b = jax_results.save_results(ref_tracker, ref_s,
                                     root / f"jax_{fmt}.results", fmt)
    finally:
        ref_s.set("track_engine", "fast")
    assert a.read_bytes() == b.read_bytes()


def _recognition_and_tracklet_images(mod, tracker, s, d, pv):
    mod.export_recognition(tracker, s, d, "v")
    mod.export_tracklet_images(tracker, s, d, "v")


def test_unported_exports_raise_naming_their_roadmap_item(tracked):
    """export_recognition and export_tracklet_images (refused until the
    VI apply slice) write the JAX package's bytes from the fast engine's
    archives: one probability row per assigned blob with a stored
    prediction (the same rows, drawn from a seed, on both trackers), the
    tracklets' median crops and, with tracklet_max_images 0, every
    sampled crop."""
    root, out = tracked
    ref_tracker = out["jax"][0]
    tracker = out["fast"][0]
    rng = np.random.default_rng(11)
    predicted = {}
    for fid, ind in sorted(ref_tracker.individuals.items()):
        for b in ind.basic[::2]:
            predicted.setdefault(b.frame, {})[b.blob.blob_id] = \
                rng.dirichlet(np.ones(6)).astype(np.float32)
    ref_tracker.predicted, tracker.predicted = predicted, dict(predicted)
    try:
        for max_images in (0, 3):
            _export_pair(root, out, "fast", f"vi_{max_images}",
                         _recognition_and_tracklet_images,
                         tracklet_max_images=max_images)
    finally:
        ref_tracker.predicted, tracker.predicted = {}, {}
    names = _files(root / "vi_0_fast")
    assert sum("_recognition_" in k for k in names) == len(
        ref_tracker.individuals)
    assert "v_tracklet_images.npz" in names \
        and "v_tracklet_images_single_part0.npz" in names


STAT_TIMING = (0, 3, 4)   # adding, loading and posture seconds


def assert_statistics_equal(ref_path, got_path):
    """The statistics npz: frames and every column exact, the timing
    columns (wall clock) for shape and finiteness only."""
    a, b = np.load(ref_path), np.load(got_path)
    assert sorted(a.files) == sorted(b.files) == ["frames", "stats"]
    np.testing.assert_array_equal(a["frames"], b["frames"])
    sa, sb = a["stats"], b["stats"]
    assert sa.shape == sb.shape and sa.dtype == sb.dtype
    keep = [c for c in range(sa.shape[1]) if c not in STAT_TIMING]
    np.testing.assert_array_equal(sa[:, keep], sb[:, keep])
    assert np.isfinite(sb[:, list(STAT_TIMING)]).all()


@pytest.mark.parametrize("engine", ["fast", "device"])
def test_statistics_heatmaps_annotations_equal_jax(tracked, engine):
    """output_statistics (with the memory file), output_heatmaps in
    every normalisation and track_annotations, from the port's engines,
    equal the JAX package's from its FastTracker."""
    from trex_tpu.track import annotations as jax_annotations
    from trex_tpu.track import heatmap as jax_heatmap
    from trex_tpu_torch.track import annotations, heatmap

    root, out = tracked
    ref, ref_s, _ = out["jax"]
    got, s, _ = out[engine]
    jd, pd = root / f"stats_jax_{engine}", root / f"stats_{engine}"
    ref_s.set("auto_no_memory_stats", False)
    s.set("auto_no_memory_stats", False)
    want = jax_export.export_statistics(ref, ref_s, jd, "v")
    have = port_export.export_statistics(got, s, pd, "v")
    assert [p.name for p in have] == [p.name for p in want] \
        == ["v_statistics.npz", "v_memory.npz"]
    assert_statistics_equal(want[0], have[0])
    a, b = np.load(want[1]), np.load(have[1])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for norm, frames, source in (("cell", 0, ""), ("value", 5, ""),
                                 ("variance", 0, "X"), ("none", 3, "")):
        for st in (ref_s, s):
            st.set("heatmap_normalization", norm)
            st.set("heatmap_frames", frames)
            st.set("heatmap_source", source)
            st.set("heatmap_resolution", 32)
        pa = jax_heatmap.export_heatmaps(ref, ref_s, jd / norm, "v")
        pb = heatmap.export_heatmaps(got, s, pd / norm, "v")
        assert pa.name == pb.name and pa.read_bytes() == pb.read_bytes()
    amap = {"0": ["[1,0,[[10.0,20.0],[30.0,45.5]]]"],
            3: ["[0,2,[[1,2],[3,4],[5,7]]]", "[2,1,[[9,9]]]"]}
    pa = jax_annotations.export_annotations(amap, jd, "v")
    pb = annotations.export_annotations(amap, pd, "v")
    assert pa.read_bytes() == pb.read_bytes()
    ja = jax_annotations.AnnotationMap.from_dict(amap)
    pa_ = annotations.AnnotationMap.from_dict(amap)
    assert pa_.to_dict() == ja.to_dict()
    assert list(pa_.training_rows()) == list(ja.training_rows())


def test_memory_stats_equal_jax(tracked, capsys):
    from trex_tpu.utils import memory as jax_memory
    from trex_tpu.utils import memstats as jax_memstats
    from trex_tpu_torch.utils import memory, memstats

    _, out = tracked
    ref, got = out["jax"][0], out["fast"][0]
    a = jax_memstats.tracker_memory_stats(ref)
    b = memstats.tracker_memory_stats(got)
    assert (a.bytes, a.sizes, a.details) == (b.bytes, b.sizes, b.details)
    a.print()
    want = capsys.readouterr().out
    b.print()
    assert capsys.readouterr().out == want and "[memory] tracker" in want
    assert memory.memory_stats(got) == jax_memory.memory_stats(ref)
    assert memory.format_bytes(123456789) \
        == jax_memory.format_bytes(123456789)


def _load(mod, reset):
    tracker = SimpleNamespace(settings=reset(), individuals={},
                              active=set(), _next_id=0)
    return mod.load_results(tracker, GOLDEN)


def test_load_golden_results_equals_jax():
    got = _load(port_results, reset_global_settings)
    want = _load(jax_results, jax_reset)
    assert (got.frame_times, got.start_frame, got.end_frame, got.active,
            got._next_id, got.loaded_tags) \
        == (want.frame_times, want.start_frame, want.end_frame,
            want.active, want._next_id, want.loaded_tags)
    assert sorted(got.individuals) == sorted(want.individuals)
    for fid, ind in want.individuals.items():
        g = got.individuals[fid]
        assert [b.frame for b in g.basic] == [b.frame for b in ind.basic]
        for a, b in zip(g.basic, ind.basic):
            assert (a.centroid.x, a.centroid.y, a.centroid.vx,
                    a.centroid.angle, a.thresholded_size, a.blob.split,
                    a.blob.parent_id) \
                == (b.centroid.x, b.centroid.y, b.centroid.vx,
                    b.centroid.angle, b.thresholded_size, b.blob.split,
                    b.blob.parent_id)
            np.testing.assert_array_equal(a.blob.lines, b.blob.lines)
        assert g.tracklets == ind.tracklets
        assert [p.frame for p in g.posture] == [p.frame for p in ind.posture]
        for a, b in zip(g.posture, ind.posture):
            assert (a.midline_length, a.midline_angle, a.outline_size) \
                == (b.midline_length, b.midline_angle, b.outline_size)
            np.testing.assert_array_equal(a.midline.segments,
                                          b.midline.segments)
            if b.outline is not None:
                np.testing.assert_array_equal(a.outline, b.outline)
    gs, ws = got.category_store, want.category_store
    assert gs.categories == ws.categories
    assert [vars(r) for r in gs.labeled_ranges()] \
        == [vars(r) for r in ws.labeled_ranges()]
    assert gs._blob_labels == ws._blob_labels
