"""Per-subsystem memory accounting.

Counterpart of ``trex_tpu/utils/memstats.py`` (the reference's
tracking/MemoryStats.{h,cpp}: per-individual and tracker-wide byte maps
with nested details, summed with += and printed; surfaced through
`gui_show_memory_stats` and the `output_statistics` memory file).

`individual_memory_stats` walks one Individual's archives (basic stuff
blob lines/pixels, motion records, posture outlines/midlines, tracklet
tables); `tracker_memory_stats` sums all individuals and adds the
tracker-level stores (frame times, statistics, background,
predictions). It reads any engine that serves `individuals`.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np


@dataclass
class MemoryStats:
    """Bytes per subsystem, with nested detail maps
    (MemoryStats.h:11-50)."""
    id: int = -1
    bytes: int = 0
    sizes: dict = field(default_factory=dict)
    details: dict = field(default_factory=dict)

    def add(self, name: str, n: int, detail: str = None):
        n = int(n)
        self.bytes += n
        self.sizes[name] = self.sizes.get(name, 0) + n
        if detail is not None:
            d = self.details.setdefault(name, {})
            d[detail] = d.get(detail, 0) + n

    def __iadd__(self, other: "MemoryStats"):
        self.bytes += other.bytes
        for k, v in other.sizes.items():
            self.sizes[k] = self.sizes.get(k, 0) + v
        for name, m in other.details.items():
            d = self.details.setdefault(name, {})
            for k, v in m.items():
                d[k] = d.get(k, 0) + v
        self.id = -2  # merged
        return self

    def print(self, file=None):
        file = file or sys.stdout
        who = "all" if self.id == -2 else f"individual {self.id}" \
            if self.id >= 0 else "tracker"
        print(f"[memory] {who}: {_fmt(self.bytes)}", file=file)
        for name in sorted(self.sizes, key=self.sizes.get,
                           reverse=True):
            print(f"  {name:24s} {_fmt(self.sizes[name]):>10s}",
                  file=file)
            for k, v in sorted(self.details.get(name, {}).items(),
                               key=lambda kv: -kv[1]):
                print(f"    {k:22s} {_fmt(v):>10s}", file=file)


def _fmt(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def _nbytes(a) -> int:
    if a is None:
        return 0
    if isinstance(a, np.ndarray):
        return a.nbytes
    return sys.getsizeof(a)


def individual_memory_stats(ind) -> MemoryStats:
    """IndividualMemoryStats: blobs / motion / posture / tracklets."""
    st = MemoryStats(id=int(ind.identity))
    for b in ind.basic:
        blob = b.blob
        st.add("blobs", _nbytes(getattr(blob, "lines", None)), "lines")
        st.add("blobs", _nbytes(getattr(blob, "pixels", None)),
               "pixels")
        st.add("motion", 8 * 8, "centroid")  # pos/v/a/angle doubles
    for p in ind.posture:
        out = getattr(p, "outline", None)
        st.add("posture", _nbytes(out), "outlines")
        ml = getattr(p, "midline", None)
        if ml is not None and not ml.empty:
            st.add("posture", _nbytes(ml.segments)
                   + _nbytes(ml.heights), "midlines")
    st.add("tracklets", 16 * len(ind.tracklets))
    return st


def tracker_memory_stats(tracker) -> MemoryStats:
    """TrackerMemoryStats: individuals summed + global stores."""
    total = MemoryStats(id=-1)
    for ind in tracker.individuals.values():
        total += individual_memory_stats(ind)
    total.id = -1
    total.add("frame_times", 16 * len(tracker.frame_times))
    total.add("statistics", 64 * len(tracker.statistics))
    bg = getattr(tracker, "background", None)
    total.add("background", _nbytes(bg))
    for f, per in getattr(tracker, "predicted", {}).items():
        for _, probs in per.items():
            total.add("vi_predictions", _nbytes(np.asarray(probs)))
    return total
