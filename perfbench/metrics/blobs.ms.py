"""``blobs.ms``: host ms a frame in the blob conversion (span ``blobs``:
``detect.yolo.boxes_to_blobs`` or ``obbs_to_blobs``)."""


def read(t):
    if not t.frames or "blobs" not in t.spans:
        return None
    return 1e3 * t.span_total("blobs") / t.frames
