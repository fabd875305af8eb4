"""The product's ordinary input, an image sequence, in the formats of the
reference's own footage: tests/test_export_products.py's scene
(``_synth(20, 8, 200, seed=2)``) written by ``cv2.imwrite`` as JPEG files
at quality 100 and as LZW TIFF files. The JAX CLI's ``-task convert``
reads them through cv2; the port's ``cli.trex.main(..., device="cpu")``
reads the same files with cv2 blocked, through its own decoder
(io/image_decode.py). The ``.pv`` frames and blobs, the tracked
``.results``, the CSV exports and the track task's npz and posture
exports are byte-equal (the ``.pv`` header's wall-clock timestamp
masked)."""
import sys

import cv2
import pytest

import trex_tpu_torch.io.video as port_video
from test_engine import _synth
from test_torch_cli import _mask_pv_timestamp, _run, _tree
from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.cli import trex as jax_cli
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu_torch.cli import trex as port_cli
from trex_tpu_torch.config import reset_global_settings

WRITERS = {
    "jpg": [cv2.IMWRITE_JPEG_QUALITY, 100],
    "tif": [cv2.IMWRITE_TIFF_COMPRESSION, 5],
}


def _convert_args(src, out):
    return ["-i", src, "-o", "vid", "-d", str(out), "-task", "convert",
            "-nowindow", "-auto_quit", "-track_max_individuals", "8",
            "-track_threshold", "20", "-track_max_speed", "300",
            "-track_size_filter", "[[20,400]]", "-detect_threshold", "15",
            "-average_samples", "5", "-meta_encoding", "gray",
            "-track_background_subtraction", "true", "-track_engine",
            "device", "-output_format", "csv"]


def _track_args(out):
    return ["-i", str(out / "vid.pv"), "-d", str(out / "t"), "-task",
            "track", "-nowindow", "-auto_quit", "-track_engine", "device",
            "-output_posture_data", "true"]


@pytest.mark.parametrize("ext", sorted(WRITERS))
def test_sequence_converts_and_tracks_as_the_jax_cli(tmp_path, monkeypatch,
                                                     ext):
    _, frames = _synth(20, 8, 200, seed=2)
    src = tmp_path / "vid"
    src.mkdir()
    for i, fr in enumerate(frames):
        assert cv2.imwrite(str(src / f"f_{i:03d}.{ext}"), fr, WRITERS[ext])
    pattern = str(src / f"f_%03d.{ext}")
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    assert _run(jax_cli, jax_reset, _convert_args(pattern, jax_out)) == 0
    assert _run(jax_cli, jax_reset, _track_args(jax_out)) == 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(port_video, "_cv2_mod", None)
    assert _run(port_cli, reset_global_settings,
                _convert_args(pattern, port_out)
                + ["-detect_engine", "device"], device="cpu") == 0
    assert _run(port_cli, reset_global_settings, _track_args(port_out),
                device="cpu") == 0
    want, got = _tree(jax_out), _tree(port_out)
    assert sorted(got) == sorted(want)
    assert "vid.results" in want and "vid.pv" in want
    assert sum(k.endswith(".csv") for k in want) == 8
    assert sum(k.startswith("t/data/vid_posture_") for k in want) == 8
    for name in want:
        a, b = want[name], got[name]
        if name.endswith(".pv"):
            a = _mask_pv_timestamp(a, jax_out / name)
            b = _mask_pv_timestamp(b, port_out / name)
        assert a == b, name
