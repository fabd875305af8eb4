"""The port's frame sources (trex_tpu_torch/io/video.py) and the
acquisition preprocessing of its pipeline against the JAX package's:
the background accumulator, image-sequence, ``mp4v`` video and .pv
sources,
generate_average and preprocess_video_frame. Images compare exactly.
Also: the port's default grey path runs with OpenCV absent."""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from trex_tpu import pipeline as jax_pipe
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.io import video as jax_video
from trex_tpu_torch import pipeline as port_pipe
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io import video as port_video

REPO = Path(__file__).resolve().parents[1]


def _frames(n=12, size=(48, 64), seed=0):
    rng = np.random.default_rng(seed)
    bg = rng.integers(150, 230, size, np.uint8)
    out = []
    for i in range(n):
        img = bg.copy()
        y, x = 5 + 2 * i, 8 + 3 * i
        img[y:y + 6, x:x + 10] = rng.integers(20, 90, (6, 10), np.uint8)
        out.append(img)
    return out


@pytest.mark.parametrize("method", ["mean", "max", "min", "mode"])
def test_averaging_accumulator_equals_jax(method):
    frames = _frames(9)
    a, b = port_video.AveragingAccumulator(method), \
        jax_video.AveragingAccumulator(method)
    for f in frames:
        a.add(f)
        b.add(f)
    np.testing.assert_array_equal(a.finalize(), b.finalize())


def test_unknown_averaging_method_raises():
    with pytest.raises(ValueError):
        port_video.AveragingAccumulator("median")


def _png_sequence(tmp_path, color=False):
    frames = _frames()
    for i, f in enumerate(frames):
        img = np.stack([f, f // 2, 255 - f], axis=-1) if color else f
        cv2.imwrite(str(tmp_path / f"frame_{i:03d}.png"), img)
    return str(tmp_path / "frame_%03d.png")


@pytest.mark.parametrize("color", [False, True])
def test_image_sequence_source_equals_jax(tmp_path, color):
    pattern = _png_sequence(tmp_path, color)
    a = port_video.VideoSource(pattern, color=color)
    b = jax_video.VideoSource(pattern, color=color)
    assert (len(a), a.size, a.frame_rate) == (len(b), b.size, b.frame_rate)
    for i in range(len(a)):
        np.testing.assert_array_equal(a.get(i), b.get(i))


# option sets of preprocess_video_frame and generate_average
OPTIONS = {
    "default": {},
    "invert": {"image_invert": True},
    "adjust": {"image_adjust": True, "image_contrast_increase": 1.4,
               "image_brightness_increase": -12.0},
    "crop": {"crop_offsets": [0.1, 0.05, 0.2, 0.1]},
    "equalize": {"equalize_histogram": True},
    "scale": {"meta_video_scale": 0.5},
    "mode": {"averaging_method": "mode", "average_samples": 7},
    "max": {"averaging_method": "max", "average_samples": 5},
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_generate_average_and_preprocess_equal_jax(tmp_path, name):
    pattern = _png_sequence(tmp_path)
    s, sj = reset_global_settings(), jax_reset()
    for k, v in OPTIONS[name].items():
        s.set(k, v)
        sj.set(k, v)
    src = port_video.VideoSource(pattern)
    avg = port_pipe.generate_average(src, s)
    np.testing.assert_array_equal(
        avg, jax_pipe.generate_average(jax_video.VideoSource(pattern), sj))
    for i in (0, 5, 11):
        np.testing.assert_array_equal(
            port_pipe.preprocess_video_frame(src.get(i), s),
            jax_pipe.preprocess_video_frame(src.get(i), sj))


def _mp4v_parts(tmp_path):
    """tests/test_aux.py::test_multi_video_concatenated_ingest's three
    ``mp4v`` parts (4, 5 and 6 constant frames at 64x48)."""
    paths = []
    for v in range(3):
        p = str(tmp_path / f"part{v}.mp4")
        w = cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                            (64, 48))
        for f in range(4 + v):
            w.write(np.full((48, 64, 3), 30 * v + 10 * f, np.uint8))
        w.release()
        paths.append(p)
    return paths


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("source", ["parts", "array string", "mp4", "mov"])
def test_mp4v_video_source_equals_jax(tmp_path, monkeypatch, color,
                                      source):
    """The port's VideoSource, with cv2 blocked, against the JAX
    package's on ``mp4v`` files (a single MP4 and MOV fixture of
    tests/data/video_decode, and test_aux.py's multi-video path array as
    a list and as its ``["a","b"]`` string): len, frame_rate and every
    frame, in order and after backward seeks."""
    data = REPO / "tests" / "data" / "video_decode"
    parts = _mp4v_parts(tmp_path)
    src = {"parts": parts,
           "array string": "[" + ",".join(f'"{p}"' for p in parts) + "]",
           "mp4": str(data / "ellipses_90x70.mp4"),
           "mov": str(data / "pan_112x80.mov")}[source]
    b = jax_video.VideoSource(src, color=color)
    n = len(b)
    want = [b.get(i) for i in list(range(n)) + [2, n - 1, 0, n // 2]]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(port_video, "_cv2_mod", None)
    a = port_video.VideoSource(src, color=color)
    assert (len(a), a.frame_rate) == (n, b.frame_rate)
    got = [a.get(i) for i in list(range(n)) + [2, n - 1, 0, n // 2]]
    for i, (x, y) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(x, y, err_msg=f"read {i}")
    assert a.size == b.size
    a.close()
    b.close()


def test_pv_video_source_equals_jax(tmp_path):
    from trex_tpu_torch.io.pv import PVFile, PVFrame, PVHeader

    frames = _frames(5)
    bg = np.full_like(frames[0], 200)
    p = tmp_path / "s.pv"
    with PVFile.create(p, PVHeader(width=64, height=48, average=bg,
                                   timestamp=1)) as f:
        for i, img in enumerate(frames):
            fr = PVFrame(timestamp=40_000 * (i + 1), source_index=i)
            y, x = 5 + 2 * i, 8 + 3 * i
            lines = np.array([[y + r, x, x + 9] for r in range(6)],
                             np.int32)
            fr.add_object(lines, img[y:y + 6, x:x + 10].reshape(-1))
            f.add_frame(fr)
    a, b = port_video.PVVideoSource(p), jax_video.PVVideoSource(p)
    assert (len(a), a.size, a.frame_rate) == (len(b), b.size, b.frame_rate)
    for i in range(len(a)):
        np.testing.assert_array_equal(a.get(i), b.get(i))


_NO_CV2 = r"""
import sys
sys.modules["cv2"] = None
import numpy as np
import torch
torch.set_num_threads(1)
from pathlib import Path
import trex_tpu_torch.io.video as video
import trex_tpu_torch.pipeline as pipeline
import trex_tpu_torch.export as export
import trex_tpu_torch.cli.trex as cli
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io.pv import PVFile

class Frames(video.VideoSource):
    def __init__(self, frames):
        self.frames = frames
    def __len__(self):
        return len(self.frames)
    frame_rate = 25.0
    def get(self, i):
        return self.frames[i]

rng = np.random.default_rng(1)
frames = []
for i in range(12):
    img = np.full((64, 96), 200, np.uint8)
    for k in range(3):
        y, x = 8 + 16 * k + i % 3, 6 + 5 * i + 8 * k
        img[y:y + 6, x:x + 10] = 70
    frames.append(img)
out = Path(sys.argv[1])
s = reset_global_settings()
for k, v in dict(track_max_individuals=3, track_threshold=20,
                 track_background_subtraction=True, detect_threshold=20,
                 track_max_speed=300, track_size_filter=[[10, 90]],
                 average_samples=5, averaging_method="max",
                 detect_engine="device", meta_encoding="gray",
                 track_engine="fast", calculate_posture=True).items():
    s.set(k, v)
seg = pipeline.Segmenter(s, Frames(frames), out / "g.pv", device="cpu")
tracker = seg.run()
assert type(tracker).__name__ == "FastTracker"
assert (seg.detector.frames, seg.detector.overflow_frames) == (12, 0), \
    (seg.detector.frames, seg.detector.overflow_frames)
with PVFile.open(out / "g.pv") as f:
    assert len(f) == 12 and f.read_frame(4).n == 3
paths = export.export_data(tracker, s, out / "data", "g")
paths += export.export_posture(tracker, s, out / "data", "g")
assert len(paths) >= 3
export.save_results(tracker, s, out / "g.results")
assert sys.modules["cv2"] is None
print("ok", len(tracker.individuals))
"""


def test_grey_conversion_runs_without_opencv(tmp_path):
    """The port's io.video, pipeline, export and cli.trex import with
    OpenCV absent, and a grey conversion from an in-memory source
    converts, tracks and exports without it."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", _NO_CV2, str(tmp_path)],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok 3"


def test_a_file_source_without_opencv_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(port_video, "_cv2_mod", None)
    (tmp_path / "v.mp4").write_bytes(b"")
    with pytest.raises(RuntimeError, match="OpenCV is required"):
        port_video.VideoSource(str(tmp_path / "v.mp4"))


@pytest.mark.parametrize("color", [False, True])
def test_jpeg_and_tiff_directory_without_opencv_equals_jax(
        monkeypatch, tmp_path, color):
    """A directory of JPEG (4:2:0, progressive, grey) and TIFF (LZW,
    Deflate with predictor 2, 16-bit) files decodes with cv2 blocked to
    the frames the JAX package's source reads through cv2; a video file
    still needs OpenCV."""
    writes = [(".jpg", [cv2.IMWRITE_JPEG_QUALITY, 90]),
              (".jpeg", [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
              (".tif", [cv2.IMWRITE_TIFF_COMPRESSION, 5]),
              (".tiff", [cv2.IMWRITE_TIFF_COMPRESSION, 8,
                         cv2.IMWRITE_TIFF_PREDICTOR, 2])]
    for i, f in enumerate(_frames()):
        ext, params = writes[i % len(writes)]
        img = np.stack([f, f // 2, 255 - f], axis=-1) if i % 3 else f
        if i == 5:
            img = img.astype(np.uint16) * 257
        assert cv2.imwrite(str(tmp_path / f"frame_{i:03d}{ext}"), img,
                           params)
    want = jax_video.VideoSource(str(tmp_path), color=color)
    frames = [want.get(i) for i in range(len(want))]
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(port_video, "_cv2_mod", None)
    got = port_video.VideoSource(str(tmp_path), color=color)
    assert len(got) == len(frames) == 12
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(got.get(i), f)
    (tmp_path / "v.mp4").write_bytes(b"")
    with pytest.raises(RuntimeError, match="OpenCV is required"):
        port_video.VideoSource(str(tmp_path / "v.mp4"))
