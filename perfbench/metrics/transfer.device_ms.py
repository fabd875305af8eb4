"""``transfer.device_ms``: device ms a frame of the copies between host
and card (the profiler's ``Memcpy`` operations: the tiles up in
``infer_device``, the decoded rows down in ``_infer``)."""


def read(t):
    if not t.frames or not len(t.device_intervals({"memcpy"})):
        return None
    return 1e3 * t.device_s({"memcpy"}) / t.frames
