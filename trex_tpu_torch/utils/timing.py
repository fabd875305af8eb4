"""Tracing/profiling utilities.

Re-creates the reference's observability trio:
- Timing/TakeTiming scoped timers with periodic reporting (commons
  misc/Timer.h; sprinkled on hot paths, e.g. Tracker.cpp:563,681,1104)
- TimingStatsCollector: ring buffer of {metric, start, end, frame}
  records (core/TimingStatsCollector.h:7-66)
- per-frame Statistics live on the Tracker (tracker.py FrameStatistics)
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Optional


class Timing:
    """Accumulating scoped timer that reports every `print_every`
    samples through `report` (default: print)."""

    _registry: dict[str, "Timing"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str, print_every: int = 100, report=None):
        self.name = name
        self.print_every = print_every
        self.report = report or (lambda msg: print(msg))
        self.samples = 0
        self.total = 0.0
        self._tls = threading.local()
        with Timing._lock:
            Timing._registry[name] = self

    def __enter__(self):
        self._tls.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._tls.start
        with Timing._lock:
            self.total += dt
            self.samples += 1
            if self.print_every and self.samples % self.print_every == 0:
                mean_ms = self.total / self.samples * 1e3
                self.report(f"[timing] {self.name}: {mean_ms:.3f}ms avg "
                            f"over {self.samples} samples")
        return False

    @property
    def mean_seconds(self) -> float:
        return self.total / self.samples if self.samples else 0.0

    @classmethod
    def registry(cls) -> dict[str, "Timing"]:
        with cls._lock:
            return dict(cls._registry)


@dataclass
class TimingRecord:
    metric: str
    start: float
    end: float
    frame: int = -1

    @property
    def duration(self):
        return self.end - self.start


class TimingStatsCollector:
    """Ring buffer of timing records, queryable per metric."""

    def __init__(self, capacity: int = 4096):
        self._records = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    class _Scope:
        def __init__(self, collector, metric, frame):
            self.collector = collector
            self.metric = metric
            self.frame = frame

        def __enter__(self):
            self.start = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.collector.add(TimingRecord(
                self.metric, self.start, time.perf_counter(), self.frame))
            return False

    def measure(self, metric: str, frame: int = -1):
        return self._Scope(self, metric, frame)

    def add(self, record: TimingRecord):
        with self._lock:
            self._records.append(record)

    def clear(self):
        with self._lock:
            self._records.clear()

    def records(self, metric: Optional[str] = None) -> list[TimingRecord]:
        with self._lock:
            rs = list(self._records)
        if metric is None:
            return rs
        return [r for r in rs if r.metric == metric]

    def summary(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for r in self.records():
            s = out.setdefault(r.metric, {"n": 0, "total": 0.0, "max": 0.0})
            s["n"] += 1
            s["total"] += r.duration
            s["max"] = max(s["max"], r.duration)
        for s in out.values():
            s["mean"] = s["total"] / s["n"]
        return out


def to_chrome_trace(records: list[TimingRecord], path,
                    thread_names: Optional[dict] = None) -> None:
    """Write records as Chrome trace-event JSON — the equivalent of the
    reference's per-thread timing lane chart (core/TimingStatsCollector
    consumed by the GUI's lane view); open in chrome://tracing or
    Perfetto. Records carry no thread id, so lanes group by metric."""
    import json

    lanes: dict[str, int] = {}
    events = []
    for r in records:
        tid = lanes.setdefault(r.metric, len(lanes))
        events.append({
            "name": r.metric, "ph": "X", "pid": 0, "tid": tid,
            "ts": r.start * 1e6, "dur": r.duration * 1e6,
            "args": ({"frame": r.frame} if r.frame >= 0 else {}),
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": t,
             "args": {"name": m}} for m, t in lanes.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events}, f)


_global_collector: Optional[TimingStatsCollector] = None


def global_collector() -> TimingStatsCollector:
    global _global_collector
    if _global_collector is None:
        _global_collector = TimingStatsCollector()
    return _global_collector
