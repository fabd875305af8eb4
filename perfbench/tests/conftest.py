"""The benchmark's CPU tests: the repository's root on the path, and the
tiny size every dry run uses."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# scale n at a 320 input, four-frame pools of 640 x 360: a run's whole
# path on the CPU in seconds
TINY = {
    "config": {"scale": "n", "imgsz": 320,
               "settings": {"detect_resolution": 320,
                            "detect_tile_target_width": 320,
                            "detect_batch_size": 32,
                            "detect_conf_threshold": 0.1}},
    "traffic": {"width": 640, "height": 360, "pool": 3, "animals": 8,
                "stamp_scale": 1, "calibration_frames": 1,
                "warmup_frames": 1, "check_frames": 2},
}
WORKLOADS = ("yolov8x-pose.tiled4k-32", "yolov8x-obb.tiled4k-32")


@pytest.fixture
def tiny():
    return {k: dict(v) for k, v in TINY.items()}
