"""``yolo.forward_roofline``: the least time a frame's forward could take
on the card (the larger of its operations over the peak rate and its
bytes over the memory bandwidth, counted from the layer shapes by
``perfbench/flops.py``) over the device time of the kernels launched
inside the span ``forward`` (``yolo.forward_device_ms``), in %."""


def read(t):
    if not t.frames or not len(t.device_intervals({"kernel"}, "forward")):
        return None
    device_s = t.device_s({"kernel"}, "forward") / t.frames
    least = t.tiles_per_frame * max(t.flops_per_tile / t.peak_flops,
                                    t.bytes_per_tile / t.peak_bytes_per_s)
    return 100.0 * least / device_s
