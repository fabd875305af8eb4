"""``yolo.forward_device_ms``: device ms a frame of the kernels of the
YOLO forward and decode: those launched inside the span ``forward``
(``YOLODetector.infer_device``), matched to their launches by the
profiler's correlation ids. A kernel launched anywhere else in
``apply`` is not counted here (the run's log gives their count)."""


def read(t):
    if not t.frames or not len(t.device_intervals({"kernel"}, "forward")):
        return None
    return 1e3 * t.device_s({"kernel"}, "forward") / t.frames
