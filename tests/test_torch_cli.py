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
parsing, task inference, the rst task, the options the port once
refused (tags among them), -output_visual_fields and closed_loop_enable, and
-auto_apply and the VI exports without a network, as the JAX CLI runs
them (tests/test_torch_vi_apply.py runs
them with one). -auto_train runs the accumulation as the JAX CLI does,
with its saved training images, progress and debug images, and its
auto_train_on_startup failure. A tagged scene goes through
-tags_recognize with tags_path and tags_save_predictions, then -load
-auto_tags, as through the JAX CLI."""
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
from trex_tpu.track.engine import EngineUnsupported as JaxEngineUnsupported
from trex_tpu_torch.cli import trex as port_cli
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.track.engine import EngineUnsupported

N = 4

# accumulation settings that keep the training runs short on the CPU: 16^2
# crops, two epochs, two ranges
TRAIN = ["-individual_image_size", "[16,16]", "-gpu_max_epochs", "2",
         "-gpu_min_iterations", "1", "-accumulation_max_tracklets", "2"]
# the printed uniqueness and the uniqueness of each step: both packages
# train in bfloat16 from the same weights with dropout off, and their
# networks' rows part by the bfloat16 policy's row tolerance
# (tests/test_torch_vi_network.py ROW_TOL) after every step
UNIQUENESS_TOL = 0.02


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


@pytest.mark.parametrize("flags,exc,item,jax", [
    # ported: `auto` tracks with the object Tracker, trains the network
    # and, with auto_train_dont_apply, writes the tracking's files
    (["-auto_train", "-auto_train_dont_apply", "true", *TRAIN], None,
     "vid_id0.npz", True),
    # ported: `auto` tracks with the object Tracker, and without a
    # weights file auto_apply prints the JAX CLI's note and goes on
    (["-auto_apply"], None, "[auto_apply] no weights at", True),
    # the fast engines refuse auto_apply, as the JAX FastTracker does
    (["-track_engine", "fast", "-auto_apply"], EngineUnsupported,
     "auto_apply", True),
    # ported: without categories_ordered both CLIs print the same note
    (["-auto_categorize", "true"], None,
     "[auto_categorize] categories_ordered is empty", True),
    # ported: -auto_tags without -load prints the JAX CLI's note; the
    # tags_path export without tag detection writes no tags file
    (["-auto_tags", "true"], None, "Can currently only use auto_tags",
     True),
    (["-tags_path", "tags"], None, "vid_id0.npz", True),
    # ported: the visual fields of every posture frame, with and without
    # view-blocking shapes
    (["-output_visual_fields", "true"], None, "vid_visual_field_id0.npz",
     True),
    (["-output_visual_fields", "true", "-visual_field_shapes",
      "[[[120,0],[126,0],[126,255],[120,255]]]"], None,
     "vid_visual_field_id3.npz", True),
    # ported: no prediction without -auto_apply, so no recognition file
    (["-output_recognition_data", "true"], None, "vid_id0.npz", True),
    (["-output_tracklet_images", "true"], None, "vid_tracklet_images.npz",
     True),
    # ported: the object Tracker looks for tags among the noise blobs
    (["-track_engine", "object", "-tags_enable", "true"], None,
     "vid_id0.npz", True),
    # ported: the object Tracker runs the loop; without the user module
    # both CLIs print the same note and write the same files
    (["-track_engine", "object", "-closed_loop_enable", "true"], None,
     "[closed_loop] enabled but module", True),
])
def test_unported_options_raise_naming_their_item(video, capfd, flags, exc,
                                                  item, jax):
    """Every option the port once refused before any frame behaves as
    the JAX CLI does: -auto_apply without weights prints its note
    (`item`) and writes the same files, the fast engine refuses it with
    the same message, -auto_train (short, not applied), the exports,
    tags_path and tags_enable write the JAX CLI's files (`item` names one
    of them), -auto_categorize without categories, closed_loop_enable
    without its module and -auto_tags without -load print the JAX CLI's
    note."""
    root, src = video
    out = root / "port_fast"
    if not (out / "vid.pv").exists():
        assert _run(port_cli, reset_global_settings,
                    _convert_args(src, out, "fast"), device="cpu") == 0
    tag = "_".join(f.strip("-") for f in flags)
    # each case its own copy of the .pv: -auto_train saves its weights
    # beside it, where -auto_apply would find them
    pv = _copy_pv(out / "vid.pv", root / f"pv_{tag}")
    argv = _track_args(pv.parent, "fast")[:-4] \
        + ["-d", str(root / "refused")] + flags
    if exc is None:
        dirs = {k: root / f"{tag}_{k}" for k in ("j", "p")}
        for k, cli, reset, kw in (("j", jax_cli, jax_reset, {}),
                                  ("p", port_cli, reset_global_settings,
                                   {"device": "cpu"})):
            a = argv[:-len(flags) - 2] + ["-d", str(dirs[k])] + flags
            capfd.readouterr()
            assert _run(cli, reset, a, **kw) == 0
            err = capfd.readouterr().err
            assert (item in err) == (not item.endswith(".npz"))
        want = _assert_trees_equal(dirs["j"], dirs["p"])
        assert f"data/{item}" in want or not item.endswith(".npz")
        assert not any("_recognition_" in k for k in want)
        return
    with pytest.raises(exc, match=item) as got:
        _run(port_cli, reset_global_settings, argv, device="cpu")
    assert not (root / "refused").exists()
    if jax:
        with pytest.raises(JaxEngineUnsupported) as ref:
            _run(jax_cli, jax_reset, argv)
        assert str(got.value) == str(ref.value)
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




@pytest.fixture
def same_start(monkeypatch):
    """Dropout off in both packages (flax's built with rate 0, the
    port's modules set to rate 0), and every port VITrainer starts from
    the weights the JAX VITrainer of the same network draws; the
    accumulation results of both CLIs are kept."""
    import flax.linen

    from test_torch_vi_network import _flat
    from trex_tpu.ml import accumulation as jax_acc
    from trex_tpu.models.training import VITrainer as JaxTrainer
    from trex_tpu.models.vi_network import build as jax_build
    from trex_tpu_torch.ml import accumulation
    from trex_tpu_torch.models import layers, training, vi_params

    orig = flax.linen.Dropout
    monkeypatch.setattr(flax.linen, "Dropout",
                        lambda rate, *a, **k: orig(0.0, *a, **k))
    init = training.VITrainer.__init__

    def from_jax(self, model, num_classes, image_shape, *a, **kw):
        init(self, model, num_classes, image_shape, *a, **kw)
        jt = JaxTrainer(jax_build("v118_3", num_classes), num_classes,
                        image_shape)
        vi_params.from_flax_arrays(self.model, _flat(
            {"params": jt.state.params,
             "batch_stats": jt.state.batch_stats}))
        for m in self.model.modules():
            if isinstance(m, layers.Dropout):
                m.rate = 0.0
    monkeypatch.setattr(training.VITrainer, "__init__", from_jax)
    results = {}
    for k, mod in (("j", jax_acc), ("p", accumulation)):
        start = mod.Accumulation.start

        def kept(self, *a, _start=start, _k=k, **kw):
            results[_k] = _start(self, *a, **kw)
            return results[_k]
        monkeypatch.setattr(mod.Accumulation, "start", kept)
    return results


def _train_task(pv, *flags):
    return ["-i", str(pv), "-d", str(pv.parent / "t"), "-task", "track",
            "-nowindow", "-auto_quit", "-auto_train", *TRAIN, *flags]


def test_auto_train_writes_the_jax_cli_outputs(video, capfd, same_start):
    """`-task track -auto_train -auto_train_dont_apply true` with the
    saved training images, the progress images and the debug image of
    the normalizations, on the JAX CLI and the port's from the same
    starting weights: the same accumulation steps (ranges, statuses,
    reasons; uniqueness within UNIQUENESS_TOL) and printed lines, the
    training images' npz byte-equal, the PNG files decoding to the same
    pixels where their uniqueness curves are the same (and always to the
    curve cv2.line draws from the port's own values; the PNG bytes are
    not compared, OpenCV's zlib settings and row filters are its own),
    the weights saved and the track task's output files byte-equal."""
    root, src = video
    out = root / "port_fast"
    if not (out / "vid.pv").exists():
        assert _run(port_cli, reset_global_settings,
                    _convert_args(src, out, "fast"), device="cpu") == 0
    flags = ["-auto_train_dont_apply", "true",
             "-visual_identification_save_images", "true",
             "-recognition_save_progress_images", "true",
             "-debug_recognition_output_all_methods", "true"]
    printed, pvs = {}, {}
    for k, cli, reset, kw in (("j", jax_cli, jax_reset, {}),
                              ("p", port_cli, reset_global_settings,
                               {"device": "cpu"})):
        pvs[k] = _copy_pv(out / "vid.pv", root / f"train_{k}")
        capfd.readouterr()
        assert _run(cli, reset, _train_task(pvs[k], *flags), **kw) == 0
        printed[k] = [ln for ln in capfd.readouterr().out.splitlines()
                      if ln.startswith("[auto_train]")]
    want, got = same_start["j"], same_start["p"]
    assert len(got.steps) == len(want.steps) >= 2
    for a, b in zip(want.steps, got.steps):
        assert (b.range, b.status.value, b.reason.value) \
            == (a.range, a.status.value, a.reason.value)
        assert abs(b.uniqueness - a.uniqueness) <= UNIQUENESS_TOL
    assert got.trained_ranges == want.trained_ranges
    assert got.success == want.success

    def masked(lines):
        return [ln.split("uniqueness=")[0] + ln.split(" steps=")[-1]
                if "uniqueness=" in ln else ln.replace(str(root), "")
                .replace("train_j", "train_").replace("train_p", "train_")
                for ln in lines]
    assert masked(printed["p"]) == masked(printed["j"])
    assert len(printed["p"]) == 6
    assert abs(float(printed["p"][2].split("uniqueness=")[1].split()[0])
               - float(printed["j"][2].split("uniqueness=")[1].split()[0])) \
        <= UNIQUENESS_TOL

    # the files beside the .pv
    d = {k: pv.parent for k, pv in pvs.items()}
    names = sorted(p.name for p in d["j"].iterdir() if p.is_file())
    assert names == sorted(p.name for p in d["p"].iterdir() if p.is_file())
    assert (d["p"] / "vid_weights_training_images.npz").read_bytes() \
        == (d["j"] / "vid_weights_training_images.npz").read_bytes()
    with np.load(d["p"] / "vid_weights_training_images.npz") as z:
        assert z["images"].shape[1:] == (16, 16, 1) and len(z["labels"])
    dbg = "vid_normalization_methods.png"
    np.testing.assert_array_equal(
        cv2.imread(str(d["p"] / dbg), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(d["j"] / dbg), cv2.IMREAD_UNCHANGED))
    steps = [n for n in names if "_uniqueness_step" in n]
    assert len(steps) == len(got.progress_maps) == len(want.progress_maps)
    for n, (_, _, per), (_, _, jper) in zip(steps, got.progress_maps,
                                             want.progress_maps):
        img = cv2.imread(str(d["p"] / n), cv2.IMREAD_UNCHANGED)
        ref = np.full((128, 512), 255, np.uint8)
        fs = sorted(per)
        xs = np.linspace(0, 511, len(fs)).astype(int)
        ys = 127 - (np.array([per[f] for f in fs]) * 127).astype(int)
        for i in range(1, len(fs)):
            cv2.line(ref, (xs[i - 1], ys[i - 1]), (xs[i], ys[i]), 0, 1)
        np.testing.assert_array_equal(img, ref)
        jys = 127 - (np.array([jper[f] for f in sorted(jper)])
                     * 127).astype(int)
        if np.array_equal(ys, jys):
            np.testing.assert_array_equal(
                img, cv2.imread(str(d["j"] / n), cv2.IMREAD_UNCHANGED))
    with np.load(d["p"] / "vid_weights.npz") as z:
        assert "params/Dense_1/kernel" in z.files
    _assert_trees_equal(d["j"] / "t", d["p"] / "t")


def test_auto_train_on_startup_failure_exits_as_jax(video, same_start):
    """With auto_train_on_startup an accumulation that does not reach the
    sufficient uniqueness (here 1.01, out of reach) ends the run with
    the JAX CLI's SystemExit, before any weights are saved."""
    root, src = video
    out = root / "port_fast"
    if not (out / "vid.pv").exists():
        assert _run(port_cli, reset_global_settings,
                    _convert_args(src, out, "fast"), device="cpu") == 0
    flags = ["-auto_train_on_startup", "true",
             "-accumulation_sufficient_uniqueness", "1.01"]
    msgs = []
    for k, cli, reset, kw in (("j", jax_cli, jax_reset, {}),
                              ("p", port_cli, reset_global_settings,
                               {"device": "cpu"})):
        pv = _copy_pv(out / "vid.pv", root / f"startup_{k}")
        with pytest.raises(SystemExit) as e:
            _run(cli, reset, _train_task(pv, *flags), **kw)
        msgs.append(str(e.value))
        assert not (pv.parent / "vid_weights.npz").exists()
        assert not same_start[k].success
    assert msgs[1] == msgs[0] and "auto_train_on_startup" in msgs[0]


# a tagged scene: chip_smoke's fish at 256^2, each carrying its 6x6 code
TAG_IDS = [11, 48, 85, 122, 159, 196]
TAG_SETTINGS = ["-cm_per_pixel", "0.1", "-track_size_filter",
                "[[0.4,10.0]]", "-track_threshold", "20",
                "-track_background_subtraction", "true",
                "-detect_threshold", "20", "-track_max_individuals",
                str(len(TAG_IDS))]
# the decode confidence p: the two packages' float32 forwards part in
# the last bits of the logits
TAG_P_TOL = 1e-6


@pytest.fixture(scope="module")
def tag_video(tmp_path_factory):
    """The tagged scene (6 fish, 16 frames) converted by the JAX CLI, and
    a seeded tag network (TagDecoderNet at 32x32, 256 classes) written by
    the port's HDF5 writer."""
    import chip_smoke
    from trex_tpu_torch.ml.tagwork import TagDecoderNet, \
        save_keras_sequential_h5

    root = tmp_path_factory.mktemp("tags")
    bg, frames, _ = chip_smoke.synth_scene(
        16, n_fish=len(TAG_IDS), size=256, seed=2,
        codes=[chip_smoke.tag_code(t) for t in TAG_IDS])
    (root / "vid").mkdir()
    for i, img in enumerate(frames):
        cv2.imwrite(str(root / "vid" / f"f_{i:03d}.png"), img)
    out = root / "conv"
    assert _run(jax_cli, jax_reset, [
        "-i", str(root / "vid" / "f_%03d.png"), "-o", "vid", "-d",
        str(out), "-task", "convert", "-nowindow", "-average_samples", "5",
        "-meta_encoding", "gray", "-averaging_method", "max",
        *TAG_SETTINGS]) == 0
    model = root / "tags.h5"
    save_keras_sequential_h5(model, TagDecoderNet(
        256, 32, seed=4, device="cpu").layer_specs())
    return out / "vid.pv", model


def _tag_blocks_equal(a: Path, b: Path):
    """Two .results equal but for the tag block's p, which agrees within
    TAG_P_TOL; returns the tag block."""
    from trex_tpu_torch.export.results_binary import read_results, \
        write_results

    ra, rb = read_results(a), read_results(b)
    assert ra.tags.keys() == rb.tags.keys()
    for tid, dets in ra.tags.items():
        assert dets.keys() == rb.tags[tid].keys()
        for f, (bid, p) in dets.items():
            assert rb.tags[tid][f][0] == bid
            assert abs(rb.tags[tid][f][1] - p) <= TAG_P_TOL
    rb.tags = ra.tags
    write_results(a.with_suffix(".same"), ra, ra.version)
    write_results(b.with_suffix(".same"), rb, rb.version)
    assert a.with_suffix(".same").read_bytes() \
        == b.with_suffix(".same").read_bytes()
    return ra.tags


def test_tags_recognize_then_auto_tags_equal_jax(tag_video, capfd):
    """-tags_recognize with the model, -tags_path and
    -tags_save_predictions, then -load -auto_tags, through both CLIs on
    the CPU: the tracker's tag assignments, the .results tag blocks (p
    within TAG_P_TOL), the tags npz, the crops' pixels (the PNG bytes
    differ: cv2.imwrite against the port's writer), the corrections and
    the re-tracked files."""
    from trex_tpu.pipeline import TrackingState as JaxState
    from trex_tpu_torch.pipeline import TrackingState as PortState

    pv, model = tag_video
    root = pv.parent.parent
    flags = ["-tags_recognize", "true", "-tags_model_path", str(model),
             "-tags_path", "tags", "-tags_save_predictions", "true",
             "-output_fields", '[["X",["RAW"]],["frame",[]],["qr_id",[]],'
             '["qr_p",[]]]', *TAG_SETTINGS]
    trackers = {}
    for k, cli, reset, state, kw in (
            ("j", jax_cli, jax_reset, JaxState, {}),
            ("p", port_cli, reset_global_settings, PortState,
             {"device": "cpu"})):
        p = _copy_pv(pv, root / f"tags_{k}")
        run = state.run

        def spy(self, _run=run, _k=k):
            trackers[_k] = _run(self)
            return trackers[_k]
        state.run = spy
        try:
            assert _run(cli, reset, _track_task(p, *flags), **kw) == 0
        finally:
            state.run = run
    jt, pt = trackers["j"], trackers["p"]
    assert type(pt).__name__ == "Tracker"
    assert pt.tag_assignments == jt.tag_assignments
    assert sum(len(v) for v in pt.tag_assignments.values()) >= 60
    jd, pd = root / "tags_j", root / "tags_p"
    tags = _tag_blocks_equal(jd / "vid.results", pd / "vid.results")
    assert tags
    want, got = _tree(jd), _tree(pd)
    assert sorted(got) == sorted(want)
    n_png = n_qr = 0
    for name in want:
        if name.startswith("t/data/") and name.endswith(".npz"):
            # the qr_* fields fill from the tag assignments; qr_p is the
            # decode confidence (TAG_P_TOL)
            with np.load(jd / name) as a, np.load(pd / name) as b:
                assert sorted(a.files) == sorted(b.files)
                for key in a.files:
                    if key == "qr_p":
                        np.testing.assert_allclose(b[key], a[key], rtol=0,
                                                   atol=TAG_P_TOL)
                    else:
                        np.testing.assert_array_equal(b[key], a[key])
                if "qr_id" in a.files:
                    n_qr += int(np.isfinite(a["qr_id"]).sum())
        elif name.endswith(".png"):
            a = cv2.imread(str(jd / name), cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(pd / name), cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
            n_png += 1
        elif not name.endswith((".results", ".same")):
            assert want[name] == got[name], name
    assert n_png > 0 and n_qr > 0 and "t/tags.npz" in want
    with np.load(jd / "t" / "tags.npz") as a, \
            np.load(pd / "t" / "tags.npz") as b:
        assert sorted(a.files) == sorted(b.files) and a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # -load -auto_tags: votes from the stored tags, corrections, re-track
    lines = {}
    for k, cli, reset, kw in (("j", jax_cli, jax_reset, {}),
                              ("p", port_cli, reset_global_settings,
                               {"device": "cpu"})):
        capfd.readouterr()
        assert _run(cli, reset, _track_task(
            root / f"tags_{k}" / "vid.pv", "-load", "-auto_tags", "true",
            *TAG_SETTINGS), **kw) == 0
        lines[k] = [ln for ln in capfd.readouterr().out.splitlines()
                    if ln.startswith("[auto_tags]")]
    assert lines["p"] == lines["j"]
    assert any("re-tracking" in ln for ln in lines["p"])
    assert not any("reassigned=0 " in ln for ln in lines["p"])
    _tag_blocks_equal(jd / "vid.results", pd / "vid.results")
    want, got = _tree(jd / "t" / "data"), _tree(pd / "t" / "data")
    assert want and sorted(got) == sorted(want)
    for name in want:
        assert want[name] == got[name], name
