"""``detect.host_ms``: host-clock ms a frame inside ``apply`` outside the
forward and its copies (``infer``), the tile merge and the blob
conversion: tiling, letterboxes, per-tile threshold and NMS, the grey
frame. Spans ``apply``, ``infer``, ``merge``, ``blobs``."""


def read(t):
    if not t.frames or "apply" not in t.spans:
        return None
    host = t.span_total("apply") - t.span_total("infer") \
        - t.span_total("merge") - t.span_total("blobs")
    return 1e3 * host / t.frames
