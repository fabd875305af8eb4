"""The port's ``mp4v`` writer (trex_tpu_torch/io/video_encode.py) against
cv2's ``VideoWriter`` (the JAX package's ``save_raw_movie``) on the same
frames: file bytes, mean PSNR of cv2's decode against the input, and the
encode's ms a frame (the best of `--repeats` runs of each, in turns). The
inputs: chip_smoke.py's phase-10 scene (1024^2 grey, 16 frames) and
tests/data/video_decode/write_fixtures.py's texture_pan (112x80, BGR) and
ellipses (90x70, BGR), 30 frames each, and 30 black 90x70 BGR frames (the
cost of a frame where nothing moves), all at 25 frames/s. Needs cv2;
host code only (no card). Run from the repository's root: ``python
tools/raw_movie_vs_cv2.py``; prints one JSON line a input.
tests/test_torch_video_encode.py takes its inputs, cv2 writer and PSNR
from here."""
import argparse
import json
import os
import platform
import sys
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests" / "data" / "video_decode"))


FPS = 25


def inputs():
    """The inputs by name, each a list of frames."""
    import chip_smoke
    import write_fixtures as wf

    return {"scene": list(chip_smoke.synth_frames(16)[1]),
            "texture_pan": wf.texture_pan(80, 112, 30, 3, 14),
            "ellipses": wf.ellipses(70, 90, 30, 1),
            "black": [np.zeros((70, 90, 3), np.uint8)] * 30}


def frame_psnr(a, b) -> float:
    """PSNR of two frames in dB, 99 where they are equal."""
    d = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.0 if d == 0 else float(10 * np.log10(255 ** 2 / d))


def write_cv2(path, frames, fps):
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h), frames[0].ndim == 3)
    t0 = time.perf_counter()
    for f in frames:
        vw.write(f)
    vw.release()
    return time.perf_counter() - t0


def write_port(path, frames, fps):
    from trex_tpu_torch.io.video_encode import VideoWriter

    h, w = frames[0].shape[:2]
    vw = VideoWriter(path, fps, (w, h), frames[0].ndim == 3)
    t0 = time.perf_counter()
    for f in frames:
        vw.write(f)
    vw.release()
    return time.perf_counter() - t0


def psnr(path, frames) -> float:
    """Mean PSNR of cv2's decode of `path` against `frames` (grey frames
    against the decode's ``cvtColor(BGR2GRAY)``)."""
    cap = cv2.VideoCapture(str(path))
    out = []
    for f in frames:
        ok, g = cap.read()
        assert ok, path
        if f.ndim == 2:
            g = cv2.cvtColor(g, cv2.COLOR_BGR2GRAY)
        out.append(frame_psnr(g, f))
    cap.release()
    return float(np.mean(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=7)
    args = ap.parse_args()
    from trex_tpu_torch.ops.labeling import _lib

    _lib()  # the host library's build is not timed
    with tempfile.TemporaryDirectory() as tmp:
        for name, frames in inputs().items():
            row = dict(input=name, size=list(frames[0].shape),
                       frames=len(frames), host=platform.processor()
                       or platform.machine(), cpus=os.cpu_count())
            writers = (("cv2", write_cv2), ("port", write_port))
            best = {who: float("inf") for who, _ in writers}
            for _ in range(args.repeats):  # in turns: the host is shared
                for who, write in writers:
                    best[who] = min(best[who], write(
                        Path(tmp) / f"{name}_{who}.mp4", frames, FPS))
            for who, _ in writers:
                path = Path(tmp) / f"{name}_{who}.mp4"
                row[who] = dict(bytes=path.stat().st_size,
                                psnr_db=psnr(path, frames),
                                ms_per_frame=best[who] * 1e3 / len(frames))
            row["bytes_ratio"] = row["port"]["bytes"] / row["cv2"]["bytes"]
            row["psnr_diff_db"] = row["port"]["psnr_db"] \
                - row["cv2"]["psnr_db"]
            row["time_ratio"] = row["port"]["ms_per_frame"] \
                / row["cv2"]["ms_per_frame"]
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
