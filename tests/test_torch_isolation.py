"""The port stands alone: it imports neither JAX nor trex_tpu (nor h5py,
nor, at import time, OpenCV, which the machine with the card lacks), and its
entry points do not fall back to the CPU without being asked."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["jax"] = None
sys.modules["cv2"] = None
sys.modules["h5py"] = None
import importlib, pkgutil
import trex_tpu_torch
names = ["trex_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(trex_tpu_torch.__path__,
                                          "trex_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "trex_tpu" or m.startswith("trex_tpu.")
             or m == "jax" and sys.modules[m] is not None)
# a small YOLO detection and a pose posture on the CPU, cv2 blocked
import numpy as np
from trex_tpu_torch.config import Settings
from trex_tpu_torch.detect.base import create_detection
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.posture import calculate_posture_from_pose
s = Settings()
for k, v in dict(detect_type="yolo", detect_resolution=64,
                 detect_conf_threshold=0.0, detect_tile_image=2).items():
    s.set(k, v)
img = np.full((96, 128, 3), 200, np.uint8)
img[40:48, 30:46] = 60
blobs = create_detection(s, device="cpu").apply(0, img)
assert blobs and all(b.prediction["keypoints"] is None for b in blobs)
blob = TrackBlob(np.array([[y, 30, 45] for y in range(40, 48)], np.int32),
                 np.full(8 * 16, 60, np.uint8))
kp = np.array([[31, 44], [35, 44], [39, 44], [43, 44]], np.float64)
assert calculate_posture_from_pose(blob, kp, s).midline is not None
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_without_jax_or_trex_tpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n, bad = r.stdout.split(" ", 1)
    assert int(n) >= 91 and bad.strip() == "[]"


def test_no_jax_import_lines():
    files = list((REPO / "trex_tpu_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py", REPO / "torch_profile.py",
           REPO / "kernel_ab.py",
           REPO / "tests" / "test_torch_ccl_kernel.py",
           REPO / "tests" / "torch_parallel_ranks.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            for mod in ("jax", "trex_tpu"):
                assert not (s.startswith(f"import {mod}")
                            and not s.startswith(f"import {mod}_")), (f, s)
                assert not (s.startswith(f"from {mod} ")
                            or s.startswith(f"from {mod}.")), (f, s)


def test_no_h5py_anywhere_and_no_cv2_in_the_tag_modules():
    """The card's machine has neither h5py nor OpenCV: no module of the
    port imports h5py, and the tag and detection slices' modules import
    no cv2 (the older lazy cv2 imports for video decode and optional
    image operations stay)."""
    tag_modules = {"io/hdf5.py", "track/tag_image.py", "track/tags.py",
                   "ml/tagwork.py", "ml/auto_tags.py", "track/posture.py",
                   "io/encoding.py", "models/yolo.py",
                   "models/yolo_convert.py", "detect/__init__.py",
                   "detect/base.py", "detect/yolo.py", "detect/tiling.py",
                   "detect/rotated.py", "detect/region.py",
                   "detect/prediction_filter.py", "models/sam.py",
                   "detect/sam3.py"}
    root = REPO / "trex_tpu_torch"
    seen = set()
    for f in root.rglob("*.py"):
        rel = f.relative_to(root).as_posix()
        mods = ("h5py", "cv2") if rel in tag_modules else ("h5py",)
        seen.add(rel)
        for line in f.read_text().splitlines():
            s = line.strip()
            for mod in mods:
                assert not (s.startswith(f"import {mod}")
                            or s.startswith(f"from {mod}")), (rel, s)
    assert tag_modules <= seen


def test_entry_points_need_cuda_unless_cpu_asked():
    from trex_tpu_torch import resolve_device
    from trex_tpu_torch.ops.device_pipeline import detect_batch
    from trex_tpu_torch.ops.device_tracker import (
        _carry_to_vec, _detect_kwargs, _init_carry, default_split_spec,
        fused_scan_packed, make_aux, params_from_settings, scan_packed,
        track_video_device)
    from trex_tpu_torch.ml.tagwork import (KerasSequential, TagDecoderNet,
                                           train_tag_decoder)
    from trex_tpu_torch.config import Settings
    from trex_tpu_torch.detect.base import create_detection
    from trex_tpu_torch.detect.yolo import YOLODetector
    from trex_tpu_torch.models.yolo_convert import \
        load_ultralytics_checkpoint
    from trex_tpu_torch.track.device_engine import DeviceTracker

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    assert resolve_device("cpu") == torch.device("cpu")
    frames = np.full((1, 16, 16), 200, np.uint8)
    base = dict(match_mode="approximate", track_do_history_split=False,
                calculate_posture=False, track_max_individuals=2)
    # the product default: optimal matching and the history split
    auto = dict(base, match_mode="automatic", track_do_history_split=True,
                track_max_speed=300, frame_rate=25, cm_per_pixel=1.0,
                track_threshold=20, track_background_subtraction=True)
    P = params_from_settings(auto)
    aux = make_aux(_carry_to_vec(_init_carry(P, device="cpu")).numpy(),
                   [0.0], [0])
    kw = _detect_kwargs(auto, {})
    calls = [lambda: resolve_device(),
             lambda: detect_batch(frames, frames[0], threshold=15)]
    for s in (base, auto):
        calls += [lambda s=s: track_video_device(frames, frames[0], s),
                  lambda s=s: DeviceTracker(s, frames[0])]
    calls += [lambda: scan_packed(np.zeros((1, 6)), aux, P, 1),
              lambda: fused_scan_packed(frames, frames[0], aux, P,
                                        split_spec=default_split_spec(auto),
                                        **kw)]
    # the tag network (B13) and its training step
    crops = np.zeros((2, 16, 16), np.uint8)
    calls += [lambda: KerasSequential([]), lambda: TagDecoderNet(4, 16),
              lambda: train_tag_decoder(crops, np.zeros(2), 4, epochs=1)]
    # the detection facade, the YOLO detector and its checkpoint loader
    yolo = Settings()
    yolo.set("detect_type", "yolo")
    calls += [lambda: create_detection(yolo), lambda: YOLODetector(yolo),
              lambda: load_ultralytics_checkpoint(REPO / "missing.pt")]
    # several devices: the mesh of every card, the sharded detector and
    # tracker, the rank launcher, the trainer's mesh and the dryrun
    from trex_tpu_torch.models import VITrainer, build
    from trex_tpu_torch.ops.device_tracker import track_videos_sharded
    from trex_tpu_torch.parallel import dryrun, hybrid_mesh, launch, \
        make_mesh
    from trex_tpu_torch.parallel.distributed import rank_device
    from trex_tpu_torch.pipeline import DeviceDetector

    calls += [lambda: make_mesh(), lambda: hybrid_mesh(), rank_device,
              lambda: DeviceDetector(Settings(), frames[0]),
              lambda: track_videos_sharded(frames[None], frames[0], base),
              lambda: launch(print, 2), lambda: dryrun.entry(),
              lambda: dryrun.dryrun_multichip(2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # the same calls run when the CPU is asked for
    scan_packed(np.zeros((1, 6)), aux, P, 1, device="cpu")
    fused_scan_packed(frames, frames[0], aux, P,
                      split_spec=default_split_spec(auto), device="cpu",
                      **kw)
    DeviceTracker(auto, frames[0], device="cpu").track_frames(frames)
    train_tag_decoder(crops, np.zeros(2), 4, epochs=1, device="cpu")


def test_stencil_on_other_devices_raises():
    """label_components(use_pallas=True) runs the CUDA kernel or, for a
    CPU tensor, its plain version; any other device raises."""
    from trex_tpu_torch.ops.cc_device import label_components, neighbor_min

    with pytest.raises(ValueError, match="unsupported device"):
        neighbor_min(torch.zeros((1, 4, 4), dtype=torch.int32,
                                 device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        label_components(torch.ones((4, 4), dtype=torch.uint8,
                                    device="meta"), use_pallas=True)
    with pytest.raises(ValueError, match="int32"):
        neighbor_min(torch.zeros((1, 4, 4), dtype=torch.int64))


def test_host_labeler_built_from_the_port():
    """The replay's labeler is compiled from trex_tpu_torch/native, never
    loaded from the JAX package's library; beside the copies of native/
    it holds the port's own warp.cpp (the identity crops' warp, which the
    JAX package takes from OpenCV), hostmath.cpp (the C library's
    atan2f for the visual fields' CPU path, which XLA calls),
    contours.cpp (tag detection's contour routines, OpenCV's in the JAX
    package), resize.cpp (the float32 linear resize, OpenCV's in the JAX
    package), imgproc.cpp (the pipeline's, the decoder's and the
    border's image routines, OpenCV's in the JAX package), jpeg.cpp and
    tiffcodec.cpp (the JPEG and TIFF decoders' loops, libjpeg-turbo's and
    libtiff's through OpenCV in the JAX package) and mpeg4video.cpp (the
    video decoders' MPEG-4 Part 2, MJPEG IDCT and colour conversion,
    FFmpeg's through OpenCV in the JAX package)."""
    from trex_tpu_torch.ops import labeling

    assert labeling.NATIVE == REPO / "trex_tpu_torch" / "native"
    assert labeling.SOURCES == ("labeling.cpp", "tracker_core.cpp",
                                "posture_chain.cpp", "lzo1x.cpp",
                                "imageops.cpp", "warp.cpp", "hostmath.cpp",
                                "contours.cpp", "resize.cpp", "imgproc.cpp",
                                "jpeg.cpp", "tiffcodec.cpp",
                                "mpeg4video.cpp")
    assert sorted(p.name for p in labeling.NATIVE.iterdir()) \
        == sorted(labeling.SOURCES + labeling.HEADERS)
    lib = labeling._lib()
    assert Path(lib._name).parent == REPO / "build" / "trex_tpu_torch"
    assert "libtrexnative" not in lib._name


def test_package_lists_every_module():
    import trex_tpu_torch

    mods = {m.name for m in pkgutil.walk_packages(trex_tpu_torch.__path__,
                                                  "trex_tpu_torch.")}
    for name in ("device", "convert", "kernels", "config.defaults",
                 "ops.cc_device", "ops.device_pipeline", "ops.runcc",
                 "ops.device_match", "ops.device_split",
                 "ops.device_posture", "ops.device_tracker", "ops.labeling",
                 "track.blob", "track.prefilter", "track.splitting",
                 "track.matching", "track.tracker", "track.engine",
                 "track.device_engine", "track.posture", "track.motion",
                 "track.individual", "track.cache_batch",
                 "track.archive", "config.metaparse", "config.registry",
                 "config.settings_io", "io.lzo", "io.encoding",
                 "io.patharray", "io.predictions", "io.pv", "io.video",
                 "utils.timing", "pipeline", "track.border",
                 "track.events", "export.library", "export.export",
                 "export.results_binary", "export.results", "cli.trex",
                 "ml.categorize", "utils.memstats", "utils.memory",
                 "track.heatmap", "track.annotations", "cli.pvinfo",
                 "cli.__main__", "ops.crops", "models.layers",
                 "models.vi_network", "models.backbones",
                 "models.vi_params", "models.vi_convert",
                 "models.training", "ml.vi_facade", "ml.uniqueness",
                 "ml.auto_correct", "ml.accumulation", "ml.learn_static",
                 "track.dataset_quality", "track.foi", "utils.drawing",
                 "ops.raycast", "track.visual_field", "closed_loop",
                 "io.hdf5", "track.tag_image", "track.tags",
                 "ml.tagwork", "ml.auto_tags", "models.yolo",
                 "models.yolo_convert", "detect.base", "detect.yolo",
                 "detect.tiling", "detect.rotated", "detect.region",
                 "detect.prediction_filter", "models.sam", "detect.sam3",
                 "parallel", "parallel.mesh", "parallel.distributed",
                 "parallel.dryrun", "io.image_decode", "utils.imgproc",
                 "io.containers", "io.video_decode", "io.video_encode"):
        assert f"trex_tpu_torch.{name}" in mods


def test_pipeline_converts_without_opencv_image_operations():
    """pipeline.py reaches cv2 nowhere: grey conversion, resizes,
    equalization, the undistortion, the detection options' blurs,
    adaptive threshold and morphology are the port's own copies, and the
    raw-movie writer is io/video_encode.py's; track/border.py reaches cv2
    nowhere; io/video.py reaches it only through ``_cv2``, for the
    webcam and for the image and video variants its decoders refuse
    (each call names the variant), and otherwise only through the module
    a ``_Capture`` was opened with; the parallel package imports cv2
    nowhere."""
    import ast

    root = REPO / "trex_tpu_torch"
    tree = ast.parse((root / "pipeline.py").read_text())
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "cv2"}
    assert used == set(), used
    importers = [f.name for f in ast.walk(tree)
                 if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                 and any(isinstance(n, ast.Import) and any(
                     a.name == "cv2" for a in n.names) for n in ast.walk(f))]
    assert importers == [], importers
    border = (root / "track" / "border.py").read_text()
    assert "cv2" not in border and "ImportError" not in border
    video = ast.parse((root / "io" / "video.py").read_text())
    purposes = {n.args[0].value if isinstance(n.args[0], ast.Constant)
                else n.args[0].values[0].value
                if isinstance(n.args[0], ast.JoinedStr) else None
                for n in ast.walk(video)
                if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "_cv2"}
    assert purposes == {"webcam capture", "video decode (",
                        "image decode ("}, purposes
    importers = [f.name for f in ast.walk(video)
                 if isinstance(f, ast.FunctionDef)
                 and any(isinstance(n, ast.Import) and any(
                     a.name == "cv2" for a in n.names) for n in ast.walk(f))]
    assert importers == ["_cv2"], importers
    for f in (REPO / "trex_tpu_torch" / "parallel").glob("*.py"):
        every = {m.split(".")[0] for m in _imports(ast.parse(
            f.read_text()), False)}
        assert not every & {"cv2", "jax", "trex_tpu"}, (f, every)


def test_only_video_decode_and_the_raw_writer_import_opencv():
    """``import cv2`` appears in io/video.py's ``_cv2``, nowhere else in
    the port: the raw-movie writer (pipeline.py's ``_write_raw``) records
    through io/video_encode.py, which imports no cv2."""
    import ast

    root = REPO / "trex_tpu_torch"
    users = sorted(f.relative_to(root).as_posix()
                   for f in root.rglob("*.py")
                   if "cv2" in {m.split(".")[0] for m in _imports(
                       ast.parse(f.read_text()), False)})
    assert users == ["io/video.py"], users


def test_native_sources_include_only_the_standard_library():
    """The host library's sources, the MPEG-4 Part 2 encoder and decoder
    among them, include the C++ standard library and the port's own
    headers only: no OpenCV, no FFmpeg."""
    import re

    from trex_tpu_torch.ops import labeling

    std = {"algorithm", "array", "atomic", "cmath", "cstddef", "cstdint",
           "cstdio", "cstdlib", "cstring", "functional", "limits",
           "numeric", "thread", "utility", "vector"}
    for name in labeling.SOURCES + labeling.HEADERS:
        text = (labeling.NATIVE / name).read_text()
        for inc in re.findall(r'#include\s*([<"][^>"]+[>"])', text):
            body = inc[1:-1]
            assert body in std or (inc[0] == '"' and body
                                   in labeling.HEADERS), (name, inc)


_NO_CV2_RAW = r"""
import sys
sys.modules["cv2"] = None
sys.modules["jax"] = None
import numpy as np
from pathlib import Path
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io.image_decode import imread
from trex_tpu_torch.io.video_decode import VideoFile, refused_variant
from trex_tpu_torch.pipeline import Segmenter
from trex_tpu_torch.utils.drawing import write_png
root = Path(sys.argv[1])
for f in range(6):
    img = np.full((48, 64), 200, np.uint8)
    img[10:16, 5 + 3 * f:15 + 3 * f] = 80
    write_png(root / f"f_{f:03d}.png", img)
s = reset_global_settings()
for k, v in dict(save_raw_movie=True, frame_rate=30, cm_per_pixel=1.0,
                 track_threshold=20, detect_threshold=15,
                 meta_encoding="gray").items():
    s.set(k, v)
Segmenter(s, str(root / "f_%03d.png"), root / "r.pv", track=False,
          device="cpu").run()
movie = root / "r.mov.mp4"
assert refused_variant(movie) is None
v = VideoFile(movie)
assert (len(v), v.frame_rate) == (6, 30.0), (len(v), v.frame_rate)
grey = v.read(5, False)
assert abs(int(grey[12, 25]) - 80) < 8 and abs(int(grey[40, 60]) - 200) < 8
bad = sorted(m for m in sys.modules if m == "trex_tpu"
             or m.startswith("trex_tpu.") or m in ("cv2", "jax")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_raw_movie_without_opencv_or_jax(tmp_path):
    """In a process where cv2 and jax cannot be imported, the port's
    Segmenter records ``save_raw_movie`` (io/video_encode.py and the
    native encoder) and its own decoder reads it back; neither trex_tpu
    nor cv2 is loaded."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_CV2_RAW, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"


def _imports(tree, top_level_only):
    """The module names an AST imports (at its top level only, or
    anywhere in it)."""
    import ast

    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_opencv_at_import_time():
    """The machine with the card has no OpenCV: no module of the port
    imports cv2 at its top level (a function that needs it imports it
    where it runs), and the visual-field modules, whose convex hull
    replaces cv2.convexHull, and the raw-movie writer and its muxer
    import it nowhere, nor JAX or trex_tpu."""
    import ast

    new = {"ops/raycast.py", "track/visual_field.py", "closed_loop.py",
           "io/video_encode.py", "io/containers.py"}
    root = REPO / "trex_tpu_torch"
    files = sorted(root.rglob("*.py"))
    assert {f.relative_to(root).as_posix() for f in files} >= new
    for f in files:
        tree = ast.parse(f.read_text())
        top = {m.split(".")[0] for m in _imports(tree, True)}
        assert "cv2" not in top, f
        if f.relative_to(root).as_posix() in new:
            every = {m.split(".")[0] for m in _imports(tree, False)}
            assert not every & {"cv2", "jax", "trex_tpu"}, (f, every)


@pytest.mark.parametrize("name", ["labeling.cpp", "tracker_core.cpp",
                                  "posture_chain.cpp", "simd_clones.h",
                                  "lzo1x.cpp", "imageops.cpp"])
def test_native_copies_equal_the_jax_package_sources(name):
    """The port's native sources are byte-equal copies of native/."""
    assert (REPO / "trex_tpu_torch" / "native" / name).read_bytes() \
        == (REPO / "native" / name).read_bytes()


def test_params_table_equals_the_jax_package_table():
    assert (REPO / "trex_tpu_torch" / "config" / "params_table.json") \
        .read_bytes() == (REPO / "trex_tpu" / "config"
                          / "params_table.json").read_bytes()


def test_cli_track_without_a_card_raises(tmp_path, monkeypatch):
    """main(["-i", pv, "-task", "track"]) with no card and no
    device="cpu" raises under the default and the device engine rather
    than track on the host, and writes nothing."""
    from trex_tpu_torch.cli.trex import main
    from trex_tpu_torch.config import reset_global_settings
    from trex_tpu_torch.io.pv import PVFile, PVFrame, PVHeader

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pv = tmp_path / "v.pv"
    with PVFile.create(pv, PVHeader(width=16, height=16, timestamp=1,
                                    average=np.full((16, 16), 200,
                                                    np.uint8))) as f:
        fr = PVFrame(timestamp=1, source_index=0)
        fr.add_object(np.array([[3, 2, 9]], np.int32),
                      np.full(8, 60, np.uint8))
        f.add_frame(fr)
    for extra in ([], ["-track_engine", "device"]):
        reset_global_settings()
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["-i", str(pv), "-d", str(tmp_path / "out"), "-task",
                  "track", "-auto_quit", "-track_background_subtraction",
                  "true", "-track_threshold", "20"] + extra)
    reset_global_settings()
    assert not (tmp_path / "out").exists()
    assert not pv.with_suffix(".results").exists()


_NO_CV2_OPTIONS = """
import json, sys
from pathlib import Path
sys.modules["cv2"] = None
import numpy as np
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io.pv import PVFile
from trex_tpu_torch.pipeline import Segmenter
from trex_tpu_torch.track.border import Border
root = Path(sys.argv[1])
runs = json.loads((root / "runs.json").read_text())
for name, (source, values) in runs.items():
    s = reset_global_settings()
    for k, v in values.items():
        s.set(k, v)
    Segmenter(s, source, root / f"port_{name}.pv", track=False,
              device="cpu").run()
arena = np.load(root / "arena.npy")
out = {}
for kind in ("outline", "heatmap"):
    s = reset_global_settings()
    for k, v in json.loads((root / "border.json").read_text()).items():
        s.set(k, v)
    s.set("recognition_border", kind)
    if kind == "outline":
        b = Border(s, arena)
    else:
        pv = PVFile.open(root / "port_png.pv")
        b = Border(s, pv.header.average)
        b.update_from_video(pv)
    out[kind + "_mask"] = b._mask
    out[kind + "_distance"] = np.array(
        [b.distance(x + 0.5, y + 0.25) for y in range(0, 96, 5)
         for x in range(0, 128, 7)])
np.savez(root / "port_border.npz", **out)
assert sys.modules["cv2"] is None
print("ok", len(runs))
"""


def test_options_run_without_opencv_and_equal_jax(tmp_path):
    """With cv2 blocked, the port converts a PNG and a BMP sequence,
    each of the six host detection options and ``cam_undistort``, and
    builds the ``outline`` and ``heatmap`` borders; every ``.pv``
    payload, mask and distance equals the JAX package's with cv2."""
    import json

    import cv2

    from trex_tpu.config import reset_global_settings as jax_reset
    from trex_tpu.io.pv import PVFile as JaxPVFile
    from trex_tpu.pipeline import Segmenter as JaxSegmenter
    from trex_tpu.track.border import Border as JaxBorder

    rng = np.random.default_rng(12)
    for f in range(8):
        img = np.full((96, 128), 200, np.int16) + rng.integers(-5, 6,
                                                               (96, 128))
        for k in range(4):
            x, y = 10 + 25 * k + 2 * f, 15 + 18 * k
            img[y:y + 7, x:x + 12] = 90 + 15 * k
        img[80, 20 + f:34 + f] = 180
        img = np.clip(img, 0, 255).astype(np.uint8)
        cv2.imwrite(str(tmp_path / f"g_{f:03d}.png"), img)
        cv2.imwrite(str(tmp_path / f"c_{f:03d}.bmp"),
                    np.stack([img, np.roll(img, 1, 1), img], -1))
    png, bmp = str(tmp_path / "g_%03d.png"), str(tmp_path / "c_%03d.bmp")
    base = dict(detect_threshold=15, track_threshold=20,
                track_background_subtraction=True, cm_per_pixel=1.0,
                averaging_method="max", meta_encoding="gray",
                detect_engine="host", calculate_posture=False)
    options = dict(
        use_closing=dict(use_closing=True, closing_size=4),
        dilation_size=dict(dilation_size=2),
        blur_difference=dict(blur_difference=True),
        use_adaptive_threshold=dict(use_adaptive_threshold=True),
        enable_difference=dict(enable_difference=False,
                               detect_threshold=170),
        image_square_brightness=dict(image_square_brightness=True),
        cam_undistort=dict(cam_undistort=True, cam_matrix=[
            150.0, 0, 63.5, 0, 140.0, 47.5, 0, 0, 1],
            cam_undistort_vector=[-0.3, 0.1, 0.002, -0.001, 0.02]))
    runs = {"png": (png, base), "bmp": (bmp, base)}
    runs.update({k: (png, dict(base, **v)) for k, v in options.items()})
    (tmp_path / "runs.json").write_text(json.dumps(runs))
    border = dict(track_threshold=10, track_size_filter=[[10, 400]],
                  cm_per_pixel=1.0, track_background_subtraction=True)
    (tmp_path / "border.json").write_text(json.dumps(border))
    arena = np.full((96, 128), 230, np.uint8)
    yy, xx = np.mgrid[0:96, 0:128]
    arena[np.hypot(yy - 48, xx - 64) < 38 + 5 * np.sin(
        7 * np.arctan2(yy - 48, xx - 64))] = 40
    np.save(tmp_path / "arena.npy", arena)

    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_CV2_OPTIONS,
                        str(tmp_path)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == f"ok {len(runs)}"

    def payload(cls, path):
        with cls.open(path) as pv:
            return [[(np.asarray(m).tobytes(), np.asarray(p).tobytes())
                     for m, p in zip(fr.masks, fr.pixels)]
                    for fr in (pv.read_frame(i) for i in range(len(pv)))]

    for name, (source, values) in runs.items():
        js = jax_reset()
        for k, v in values.items():
            js.set(k, v)
        JaxSegmenter(js, source, tmp_path / f"jax_{name}.pv",
                     track=False).run()
        want = payload(JaxPVFile, tmp_path / f"jax_{name}.pv")
        assert sum(len(f) for f in want) > 0, name
        assert payload(JaxPVFile, tmp_path / f"port_{name}.pv") == want, \
            name
    got = np.load(tmp_path / "port_border.npz")
    for kind in ("outline", "heatmap"):
        js = jax_reset()
        for k, v in dict(border, recognition_border=kind).items():
            js.set(k, v)
        if kind == "outline":
            b = JaxBorder(js, arena)
        else:
            pv = JaxPVFile.open(tmp_path / "jax_png.pv")
            b = JaxBorder(js, pv.header.average)
            b.update_from_video(pv)
        np.testing.assert_array_equal(got[kind + "_mask"], b._mask)
        np.testing.assert_array_equal(got[kind + "_distance"], [
            b.distance(x + 0.5, y + 0.25) for y in range(0, 96, 5)
            for x in range(0, 128, 7)])
