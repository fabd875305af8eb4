"""``merge.ms``: host ms a frame in the tile merge (span ``merge``:
``detect.yolo.merge_tile_detections``)."""


def read(t):
    if not t.frames or "merge" not in t.spans:
        return None
    return 1e3 * t.span_total("merge") / t.frames
