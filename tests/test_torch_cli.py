"""The port's trex CLI (trex_tpu_torch/cli/trex.py) against the JAX
package's: a convert and a track task with -auto_quit under
track_engine fast and device write byte-equal output directories
(port of tests/test_device_engine.py::test_cli_track_device_engine).
The only masked bytes are the .pv header's timestamp, which the writer
takes from the wall clock. The port's detection runs through the
DeviceDetector's plain path (-detect_engine device), the JAX package's
through its host labeler. Also: argument parsing, task inference, the
rst task, and the options that raise naming their ROADMAP.md item."""
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.cli import trex as jax_cli
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.io.pv import PVFile
from trex_tpu_torch.cli import trex as port_cli
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.track.engine import EngineUnsupported

N = 4


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """tests/test_device_engine.py's four fish over 20 frames at 256^2,
    as a PNG sequence."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(5)
    pos = np.array([[30.0 + 50 * i, 40.0 + 40 * i] for i in range(N)])
    vel = rng.normal(0, 1.5, (N, 2))
    (root / "vid").mkdir()
    for i in range(20):
        img = np.full((256, 256), 200, np.uint8)
        for p in pos:
            x, y = int(p[0]), int(p[1])
            img[y:y + 6, x:x + 10] = 80
            img[y + 2:y + 4, x + 7:x + 10] = 50
        cv2.imwrite(str(root / "vid" / f"f_{i:03d}.png"), img)
        pos = np.clip(pos + vel, 5, 230)
    return root, str(root / "vid" / "f_%03d.png")


def _convert_args(src, out, engine):
    return ["-i", src, "-o", "vid", "-d", str(out), "-task", "convert",
            "-nowindow", "-auto_quit", "-track_max_individuals", str(N),
            "-track_threshold", "20", "-track_max_speed", "300",
            "-track_size_filter", "[[10,90]]", "-detect_threshold", "20",
            "-average_samples", "5", "-meta_encoding", "gray",
            "-track_background_subtraction", "true",
            "-track_engine", engine, "-output_format", "csv"]


def _track_args(out, engine):
    return ["-i", str(out / "vid.pv"), "-d", str(out / "t"), "-task",
            "track", "-nowindow", "-auto_quit", "-track_engine", engine,
            "-output_posture_data", "true"]


def _run(cli, reset, argv, **kw):
    reset()
    try:
        return cli.main(argv, **kw)
    finally:
        reset()


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _mask_pv_timestamp(data: bytes, path: Path) -> bytes:
    with PVFile.open(path) as f:
        ts = struct.pack("<Q", f.header.timestamp)
    at = data.index(ts)
    return data[:at] + bytes(8) + data[at + 8:]


@pytest.mark.parametrize("engine", ["fast", "device"])
def test_convert_and_track_write_the_jax_cli_files(video, engine):
    root, src = video
    jax_out, port_out = root / f"jax_{engine}", root / f"port_{engine}"
    assert _run(jax_cli, jax_reset,
                _convert_args(src, jax_out, engine)) == 0
    assert _run(jax_cli, jax_reset, _track_args(jax_out, engine)) == 0
    assert _run(port_cli, reset_global_settings,
                _convert_args(src, port_out, engine)
                + ["-detect_engine", "device"], device="cpu") == 0
    assert _run(port_cli, reset_global_settings,
                _track_args(port_out, engine), device="cpu") == 0
    want, got = _tree(jax_out), _tree(port_out)
    assert sorted(got) == sorted(want)
    assert "vid.results" in want and "t/data/vid_posture_id0.npz" in want
    assert sum(k.endswith(".csv") for k in want) == N
    for name in want:
        a, b = want[name], got[name]
        if name.endswith(".pv"):
            a = _mask_pv_timestamp(a, jax_out / name)
            b = _mask_pv_timestamp(b, port_out / name)
        assert a == b, name


def test_auto_tracks_with_the_host_engine_when_the_cpu_is_named(
        video, capfd):
    root, src = video
    out = root / "auto"
    assert _run(port_cli, reset_global_settings,
                _convert_args(src, out, "auto"), device="cpu") == 0
    assert _run(port_cli, reset_global_settings, _track_args(out, "auto"),
                device="cpu") == 0
    assert "[FastTracker]" in capfd.readouterr().out


@pytest.mark.parametrize("argv", [
    ["-i", "a b.mp4", "-o", "x", "-auto_quit", "-track_threshold", "'-7'"],
    ["-i", "v.pv", "-nowindow", "-s", "t.settings", "-load"],
    ["-task", "track", "-d", "out dir", "-p", "pre", "-match_mode"],
    ["-track_size_filter", "[[1,", "2]]", "-cm_per_pixel", "-0.5"]])
def test_parse_args_and_task_equal_jax(argv):
    assert port_cli.parse_args(argv) == jax_cli.parse_args(argv)
    args = port_cli.parse_args(argv)
    for exists in (False, True):
        assert port_cli.determine_task(
            str(args.get("source", "")), args.get("task"), exists) \
            == jax_cli.determine_task(str(args.get("source", "")),
                                      args.get("task"), exists)


def test_rst_task_equals_jax(tmp_path):
    assert _run(jax_cli, jax_reset,
                ["-task", "rst", "-d", str(tmp_path / "j")]) == 0
    assert _run(port_cli, reset_global_settings,
                ["-task", "rst", "-d", str(tmp_path / "p")]) == 0
    a = (tmp_path / "j" / "parameters_trex.rst").read_bytes()
    assert a == (tmp_path / "p" / "parameters_trex.rst").read_bytes()


@pytest.mark.parametrize("flags,exc,item", [
    (["-load"], EngineUnsupported, "A item 2"),
    (["-track_engine", "object"], EngineUnsupported, "A item 2"),
    (["-auto_train"], NotImplementedError, "A item 3"),
    (["-auto_apply"], NotImplementedError, "A item 3"),
    (["-auto_categorize", "true"], NotImplementedError, "A item 3"),
    (["-auto_tags", "true"], NotImplementedError, "A item 3"),
    (["-tags_path", "tags"], NotImplementedError, "A item 3"),
    (["-match_mode", "benchmark"], NotImplementedError, "A item 2"),
    (["-gui_show_memory_stats", "true"], NotImplementedError, "A item 1"),
    (["-output_statistics", "true"], NotImplementedError, "A item 1"),
    (["-output_heatmaps", "true"], NotImplementedError, "A item 1"),
    (["-output_visual_fields", "true"], NotImplementedError, "A item 3"),
    (["-output_recognition_data", "true"], NotImplementedError,
     "A item 3"),
    (["-output_tracklet_images", "true"], NotImplementedError, "A item 3"),
    (["-track_annotations", "{0:[]}"], NotImplementedError, "A item 1"),
])
def test_unported_options_raise_naming_their_item(video, flags, exc, item):
    root, src = video
    out = root / "port_fast"
    if not (out / "vid.pv").exists():
        assert _run(port_cli, reset_global_settings,
                    _convert_args(src, out, "fast"), device="cpu") == 0
    argv = _track_args(out, "fast")[:-4] + ["-d", str(root / "refused")] \
        + flags
    with pytest.raises(exc, match=item):
        _run(port_cli, reset_global_settings, argv, device="cpu")
    assert not (root / "refused").exists()
    # with error_terminate the CLI exits non-zero instead
    assert _run(port_cli, reset_global_settings,
                argv + ["-error_terminate", "true"], device="cpu") == 1
