"""Host utilities of the port (counterpart of ``trex_tpu/utils/``)."""
from .memory import format_bytes, memory_stats
from .timing import Timing, TimingStatsCollector, global_collector

__all__ = ["format_bytes", "memory_stats", "Timing",
           "TimingStatsCollector", "global_collector"]
