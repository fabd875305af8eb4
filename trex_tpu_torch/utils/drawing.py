"""The two image operations the CLI's training outputs need, without
OpenCV (the machine with the card has none): a line rasterizer that
sets the pixels ``cv2.line(img, p0, p1, color, 1)`` sets (``LINE_8``,
thickness 1, points inside the image) and a writer of 8-bit grey PNG
files. The PNG decodes to the pixels ``cv2.imwrite`` stores; its bytes
differ from OpenCV's, whose zlib settings and row filters are its own.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def line(img: np.ndarray, p0, p1, color: int):
    """Set the pixels of the 8-connected line from `p0` to `p1` ((x, y),
    both inside `img`) to `color`, as OpenCV's ``LineIterator`` walks it
    (drawn left to right): the major axis steps every pixel, the minor
    one where the error term ``dx - 2 dy``, updated by ``-2 dy`` and
    ``+2 dx`` on a minor step, was negative."""
    h, w = img.shape[:2]
    (x0, y0), (x1, y1) = (tuple(int(v) for v in p) for p in (p0, p1))
    for x, y in ((x0, y0), (x1, y1)):
        if not (0 <= x < w and 0 <= y < h):
            raise ValueError(f"line end ({x}, {y}) outside a {w}x{h} image")
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = x0, y0
    for _ in range(dx + 1):
        img[y, x] = color
        minor = err < 0
        err += -2 * dy + (2 * dx if minor else 0)
        if vert:
            y += sy
            x += 1 if minor else 0
        else:
            x += 1
            y += sy if minor else 0


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data \
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path, img: np.ndarray):
    """Write a 2-D uint8 image as an 8-bit grey PNG (no filter, zlib's
    default level)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_png takes a 2-D uint8 image, not "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _chunk(b"IEND", b""))
    Path(path).write_bytes(data)
