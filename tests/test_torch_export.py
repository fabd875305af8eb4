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


def test_unported_exports_raise_naming_their_roadmap_item(tracked):
    root, out = tracked
    tracker, s, _ = out["fast"]
    for fn, item in ((port_export.export_recognition, "A item 3"),
                     (port_export.export_statistics, "A item 1"),
                     (port_export.export_tracklet_images, "A item 3")):
        with pytest.raises(NotImplementedError, match=item):
            fn(tracker, s, root / "none", "v")


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
