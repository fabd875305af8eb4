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
           REPO / "tests" / "test_torch_ccl_kernel.py"]
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
    package) and resize.cpp (the float32 linear resize, OpenCV's in the
    JAX package)."""
    from trex_tpu_torch.ops import labeling

    assert labeling.NATIVE == REPO / "trex_tpu_torch" / "native"
    assert labeling.SOURCES == ("labeling.cpp", "tracker_core.cpp",
                                "posture_chain.cpp", "lzo1x.cpp",
                                "imageops.cpp", "warp.cpp", "hostmath.cpp",
                                "contours.cpp", "resize.cpp")
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
                 "detect.prediction_filter", "models.sam", "detect.sam3"):
        assert f"trex_tpu_torch.{name}" in mods


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
    replaces cv2.convexHull, import it nowhere, nor JAX or trex_tpu."""
    import ast

    new = {"ops/raycast.py", "track/visual_field.py", "closed_loop.py"}
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
