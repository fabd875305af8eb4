"""``device.idle_share``: one minus the union of the profiler's kernel
and copy intervals over the traced window, in %; None where the trace
holds no device operation."""


def read(t):
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
