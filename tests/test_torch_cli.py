"""The port's trex CLI (trex_tpu_torch/cli/trex.py) against the JAX
package's: a convert and a track task with -auto_quit under
track_engine fast and device write byte-equal output directories
(port of tests/test_device_engine.py::test_cli_track_device_engine).
The only masked bytes are the .pv header's timestamp, which the writer
takes from the wall clock. The port's detection runs through the
DeviceDetector's plain path (-detect_engine device), the JAX package's
through its host labeler. The track task with the registry's default
settings (the object Tracker), `-load` of a JAX-written .results,
output_statistics, output_heatmaps, track_annotations and the
gui_show_memory_stats lines write the JAX CLI's bytes and lines too
(the statistics' wall-clock columns compared for shape and finiteness
only), and `pvinfo` prints the JAX inspector's lines. Also: argument
parsing, task inference, the rst task, and the options that raise
naming their ROADMAP.md item."""
import shutil
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
    (["-auto_train"], NotImplementedError, "A item 3"),
    (["-auto_apply"], NotImplementedError, "A item 3"),
    (["-auto_categorize", "true"], NotImplementedError, "A item 3"),
    (["-auto_tags", "true"], NotImplementedError, "A item 3"),
    (["-tags_path", "tags"], NotImplementedError, "A item 3"),
    (["-output_visual_fields", "true"], NotImplementedError, "A item 3"),
    (["-output_recognition_data", "true"], NotImplementedError,
     "A item 3"),
    (["-output_tracklet_images", "true"], NotImplementedError, "A item 3"),
    (["-track_engine", "object", "-tags_enable", "true"], EngineUnsupported,
     "A item 3"),
    (["-track_engine", "object", "-closed_loop_enable", "true"],
     NotImplementedError, "A item 3"),
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


def _defaults_pv(video):
    """The fixture converted by the JAX CLI with only the conversion's
    own settings: every tracking setting keeps the registry's default."""
    root, src = video
    out = root / "defaults"
    if not (out / "vid.pv").exists():
        assert _run(jax_cli, jax_reset, [
            "-i", src, "-o", "vid", "-d", str(out), "-task", "convert",
            "-nowindow", "-average_samples", "5",
            "-meta_encoding", "gray"]) == 0
    return out / "vid.pv"


def _copy_pv(pv, dest, results=False):
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(pv, dest / pv.name)
    if results:
        shutil.copy(pv.with_suffix(".results"), dest / "vid.results")
    return dest / pv.name


def _track_task(pv, *flags):
    return ["-i", str(pv), "-d", str(pv.parent / "t"), "-task", "track",
            "-nowindow", "-auto_quit", *flags]


def _assert_trees_equal(jax_dir, port_dir, statistics=False):
    want, got = _tree(jax_dir), _tree(port_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        if statistics and name.endswith("_statistics.npz"):
            from test_torch_export import assert_statistics_equal

            assert_statistics_equal(jax_dir / name, port_dir / name)
            continue
        assert want[name] == got[name], name
    return want


def test_track_with_unchanged_settings_writes_the_jax_cli_files(video,
                                                               capfd):
    """`-task track -auto_quit` with the registry's defaults: both fast
    engines refuse them, `auto` on the CPU picks the object Tracker, and
    the npz files and .results equal the JAX CLI's byte for byte."""
    root, _ = video
    pv = _defaults_pv(video)
    jpv, ppv = (_copy_pv(pv, root / f"unchanged_{k}") for k in ("j", "p"))
    assert _run(jax_cli, jax_reset, _track_task(jpv)) == 0
    capfd.readouterr()
    assert _run(port_cli, reset_global_settings, _track_task(ppv),
                device="cpu") == 0
    out = capfd.readouterr().out
    assert "[track] track_engine=auto: object Tracker (host), FastTracker " \
        "refuses track_threshold == 0" in out and "[Tracker]" in out
    want = _assert_trees_equal(jpv.parent, ppv.parent)
    assert "vid.results" in want
    assert sum(k.startswith("t/data/") and k.endswith(".npz")
               for k in want) >= N


@pytest.mark.parametrize("engine", ["object", "fast"])
def test_load_of_a_jax_results_writes_the_jax_cli_files(video, capfd,
                                                        engine):
    """`-load` restores the JAX CLI's .results into the port's object
    Tracker (with the JAX CLI's note when a fast engine was asked for)
    and exports the JAX CLI's bytes."""
    root, _ = video
    src = _copy_pv(_defaults_pv(video), root / "load_src")
    if not src.with_suffix(".results").exists():
        assert _run(jax_cli, jax_reset, _track_task(src)) == 0
    dirs = [root / f"load_{engine}_{k}" for k in ("j", "p")]
    jpv, ppv = (_copy_pv(src, d, results=True) for d in dirs)
    flags = ["-load", "-track_engine", engine]
    assert _run(jax_cli, jax_reset, _track_task(jpv, *flags)) == 0
    capfd.readouterr()
    assert _run(port_cli, reset_global_settings, _track_task(ppv, *flags),
                device="cpu") == 0
    cap = capfd.readouterr()
    assert "[track] loaded" in cap.out
    assert ("cannot restore .results state; using object" in cap.err) \
        == (engine == "fast")
    _assert_trees_equal(jpv.parent, ppv.parent)


def test_statistics_heatmaps_annotations_memory_stats_equal_jax(video,
                                                                capfd):
    """output_statistics (timing columns for shape and finiteness only,
    every other column and the memory file exact), output_heatmaps,
    track_annotations and the gui_show_memory_stats lines, against the
    JAX CLI's."""
    root, _ = video
    pv = _defaults_pv(video)
    jpv, ppv = (_copy_pv(pv, root / f"outputs_{k}") for k in ("j", "p"))
    flags = ["-output_statistics", "true", "-auto_no_memory_stats", "false",
             "-output_heatmaps", "true", "-heatmap_resolution", "32",
             "-track_annotations", '{0:["[1,0,[[1,2],[30,40]]]"]}',
             "-gui_show_memory_stats", "true"]
    assert _run(jax_cli, jax_reset, _track_task(jpv, *flags)) == 0
    want_out = capfd.readouterr().out
    assert _run(port_cli, reset_global_settings, _track_task(ppv, *flags),
                device="cpu") == 0
    got_out = capfd.readouterr().out

    def memory_lines(out):
        lines = out.splitlines()
        at = [i for i, l in enumerate(lines) if l.startswith("[memory]")]
        assert len(at) == 1
        return [l for l in lines[at[0]:] if l.startswith(("[memory]", "  "))]
    assert memory_lines(got_out) == memory_lines(want_out)
    want = _assert_trees_equal(jpv.parent, ppv.parent, statistics=True)
    for suffix in ("_statistics.npz", "_memory.npz", "_annotations.npz"):
        assert f"t/data/vid{suffix}" in want
    assert any("_heatmap_p0_32_" in k for k in want)


@pytest.mark.parametrize("flags", [
    [], ["-quiet"], ["-plain_text"],
    ["-print_parameters", "[video_length,frame_rate,meta_encoding,nope]"],
    ["-print_parameters", "[video_length]", "-plain_text"]])
def test_pvinfo_prints_the_jax_lines(video, capfd, flags):
    from trex_tpu.cli import pvinfo as jax_pvinfo
    from trex_tpu_torch.cli import pvinfo

    pv = _defaults_pv(video)
    capfd.readouterr()
    jax_reset()
    assert jax_pvinfo.main([str(pv)] + flags) == 0
    want = capfd.readouterr().out
    reset_global_settings()
    assert pvinfo.main(["-i", str(pv)] + flags) == 0
    assert capfd.readouterr().out == want and want


def test_pvinfo_fix_merge_and_module_entry(video, capfd):
    import subprocess
    import sys

    from trex_tpu.cli import pvinfo as jax_pvinfo
    from trex_tpu_torch.cli import pvinfo

    root, _ = video
    pv = _defaults_pv(video)
    capfd.readouterr()
    outs = {}
    for name, mod in (("j", jax_pvinfo), ("p", pvinfo)):
        d = root / f"pvinfo_{name}"
        one = _copy_pv(pv, d)
        assert mod.main(["-fix", str(one)]) == 0
        assert mod.main(["-merge", str(d / "m.pv"), str(one), str(one)]) == 0
        outs[name] = (capfd.readouterr().out.replace(str(d), "D"),
                      _mask_pv_timestamp((d / "m.pv").read_bytes(),
                                         d / "m.pv"), one.read_bytes())
    assert outs["p"] == outs["j"]
    r = subprocess.run([sys.executable, "-m", "trex_tpu_torch.cli.pvinfo",
                        str(pv), "-quiet"], capture_output=True, text=True,
                       timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0 and r.stdout.strip() == "20", r.stderr
