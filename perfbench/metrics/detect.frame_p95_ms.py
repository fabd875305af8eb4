"""``detect.frame_p95_ms``: the 95th percentile of ``apply``'s host-clock
time over every frame of the traced window (``statistics.quantiles``,
20 parts; with fewer than 200 frames fewer than ten lie beyond it, and
the run's log gives the count). None with fewer than two frames."""
import statistics


def read(t):
    if len(t.apply_s) < 2:
        return None
    return 1e3 * statistics.quantiles(t.apply_s, n=20)[18]
