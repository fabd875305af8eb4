"""Per-subsystem memory totals of a tracker.

Counterpart of ``trex_tpu/utils/memory.py`` (the reference's
tracking/MemoryStats.{h,cpp} behind gui_show_memory_stats): byte totals
per subsystem and per individual, and a byte formatter.
"""
from __future__ import annotations

import sys
from typing import Any

import numpy as np


def _nbytes(x: Any) -> int:
    if isinstance(x, np.ndarray):
        return x.nbytes
    return sys.getsizeof(x)


def individual_memory(ind) -> dict[str, int]:
    blobs = 0
    pixels = 0
    posture = 0
    for b in ind.basic:
        blobs += b.blob.lines.nbytes
        if b.blob.pixels is not None:
            pixels += b.blob.pixels.nbytes
    for p in ind.posture:
        if p.outline is not None:
            posture += p.outline.nbytes
        if p.midline is not None:
            posture += p.midline.segments.nbytes + p.midline.heights.nbytes
    return {
        "blobs": blobs,
        "pixels": pixels,
        "posture": posture,
        "records": len(ind.basic) * 160,  # MotionRecord + BasicStuff approx
    }


def memory_stats(tracker) -> dict[str, Any]:
    """Byte totals per subsystem + per individual."""
    per_individual = {fid: individual_memory(ind)
                      for fid, ind in tracker.individuals.items()}
    totals: dict[str, int] = {}
    for stats in per_individual.values():
        for k, v in stats.items():
            totals[k] = totals.get(k, 0) + v
    background = tracker.background.nbytes \
        if tracker.background is not None else 0
    return {
        "individuals": totals,
        "per_individual": per_individual,
        "background": background,
        "frame_times": len(tracker.frame_times) * 24,
        "total": sum(totals.values()) + background,
    }


def format_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024:
            return f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TB"
