"""Writes ``digests.json``: the sha256 of the file the port's ``mp4v``
writer (``trex_tpu_torch/io/video_encode.py``) makes of chip_smoke.py's
phase-10 scene (``synth_frames(16)``, 1024^2 grey, 25 frames/s, the rate
control on), and of the frames cv2 5.0.0's ``VideoCapture`` reads from
it: BGR and grey, in order and after the seeks. chip_smoke.py's phase 19
writes the same file on the card's machine, which has no OpenCV, and holds
it to these digests. Run from the repository's root: ``python
tests/data/video_encode/write_fixtures.py``."""
import hashlib
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import cv2

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
sys.path.insert(0, str(REPO))

SCENE = "scene_1024.mp4"
FRAMES = 16  # chip_smoke.WO_FRAMES
FPS = 25


def write_scene(path):
    """The scene through the port's writer; returns the file's sha256."""
    import chip_smoke
    from trex_tpu_torch.io.video_encode import VideoWriter

    _, frames = chip_smoke.synth_frames(FRAMES)
    w = VideoWriter(path, FPS, (frames.shape[2], frames.shape[1]), False)
    for f in frames:
        w.write(f)
    w.release()
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def main():
    # tests/data/video_decode's reading of a file by cv2
    spec = importlib.util.spec_from_file_location(
        "video_decode_fixtures", HERE.parent / "video_decode" /
        "write_fixtures.py")
    decode_fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(decode_fixtures)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / SCENE
        sha = write_scene(path)
        cap = cv2.VideoCapture(str(path))
        fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
        digests = dict(decode_fixtures.cv2_digests(path), sha256=sha, size=path.stat().st_size,
                       fourcc=fourcc.to_bytes(4, "little").decode())
    (HERE / "digests.json").write_text(json.dumps({SCENE: digests}, indent=1,
                                                  sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
