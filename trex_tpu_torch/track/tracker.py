"""Per-frame tracking statistics (counterpart of the
``FrameStatistics`` record of ``trex_tpu/track/tracker.py``, with the
fields the base configuration fills)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class FrameStatistics:
    number_fish: int = 0
    adding_seconds: float = 0.0
    match_improvements: int = 0
