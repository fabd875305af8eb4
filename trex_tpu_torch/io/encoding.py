"""Pixel encodings for .pv storage (commons processing/encoding.h role).

meta_encoding values (docs/parameters_trex.rst:1885-1893, enum order
gray/r3g3b2/rgb8/binary): r3g3b2 packs color into one byte — despite
the name, the actual bit layout (test_pixels.cpp:629-744) is
[element0:2][element1:3][element2:3] top-to-bottom; helpers convert
between BGR, gray, and r3g3b2 on the host (numpy).
"""
from __future__ import annotations

import numpy as np

from ..track.tag_image import bgr_to_gray


def bgr_to_r3g3b2(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) BGR uint8 -> (H, W) r3g3b2 uint8."""
    b = bgr[..., 0] >> 6
    g = bgr[..., 1] >> 5
    r = bgr[..., 2] >> 5
    return ((b.astype(np.uint8) << 6) | (g.astype(np.uint8) << 3)
            | r.astype(np.uint8))


def r3g3b2_to_bgr(packed: np.ndarray) -> np.ndarray:
    """(H, W) r3g3b2 -> (H, W, 3) BGR uint8.

    Channel expansion is a pure shift like the reference's
    r3g3b2_to_vec (pinned by test_pixels.cpp:636-653: 0b11100010 ->
    (192, 128, 64)), NOT a full-range rescale: the 2-bit channel tops
    out at 192 and the 3-bit channels at 224."""
    packed = packed.astype(np.uint16)
    b = (packed >> 6) << 6
    g = ((packed >> 3) & 0x7) << 5
    r = (packed & 0x7) << 5
    return np.stack([b, g, r], axis=-1).astype(np.uint8)


def _bgr_luma(b, g, r) -> np.ndarray:
    """BT.601 luma, bit-exact with OpenCV 4.x cvtColor BGR2GRAY
    (the bit-exact path: (R*9798 + G*19235 + B*3735 + 16384) >> 15;
    verified equal on 10^6 random pixels)."""
    acc = (r.astype(np.uint32) * 9798 + g.astype(np.uint32) * 19235
           + b.astype(np.uint32) * 3735 + 16384)
    return (acc >> 15).astype(np.uint8)


def r3g3b2_to_gray(packed: np.ndarray) -> np.ndarray:
    bgr = r3g3b2_to_bgr(packed)
    return _bgr_luma(bgr[..., 0], bgr[..., 1], bgr[..., 2])


def convert_to_storage(image: np.ndarray, encoding: str,
                       color_channel=None) -> np.ndarray:
    """Convert a decoded frame (gray or BGR) into the pv storage encoding
    (BackgroundSubtraction.cpp:151-188 conversion table)."""
    if encoding in ("gray", "binary"):
        if image.ndim == 3:
            if color_channel is not None and 0 <= int(color_channel) < 3:
                return image[..., int(color_channel)].copy()
            return bgr_to_gray(image)
        return image
    if encoding == "r3g3b2":
        if image.ndim == 2:
            image = np.repeat(image[..., None], 3, axis=-1)
        return bgr_to_r3g3b2(image)
    if encoding == "rgb8":
        if image.ndim == 2:
            return np.repeat(image[..., None], 3, axis=-1)
        # BGR (OpenCV) input -> pv stores RGB byte order, like the
        # Segmenter's blob pixels and header average
        return np.ascontiguousarray(image[..., ::-1])
    raise ValueError(f"unknown encoding {encoding!r}")


def storage_to_gray(pixels: np.ndarray, encoding: str) -> np.ndarray:
    """Per-pixel storage values -> grayscale (for tracking thresholds)."""
    if encoding in ("gray", "binary"):
        return pixels
    if encoding == "r3g3b2":
        return r3g3b2_to_gray(pixels)
    if encoding == "rgb8":
        # stored byte order is RGB (pv V_14 encodings)
        flat = pixels.reshape(-1, 3)
        return _bgr_luma(flat[:, 2], flat[:, 1], flat[:, 0]).reshape(
            pixels.shape[:-1] if pixels.ndim > 1 else
            (pixels.size // 3,))
    raise ValueError(f"unknown encoding {encoding!r}")


def decode_background(average: np.ndarray, encoding: str) -> np.ndarray:
    """Header average image -> the grayscale tracking background the
    conversion-time Segmenter used (RGB luma for rgb8, shift expansion
    + luma for r3g3b2)."""
    if average is None:
        return None
    if encoding == "rgb8" and average.ndim == 3:
        return _bgr_luma(average[..., 2], average[..., 1],
                         average[..., 0])
    if encoding == "r3g3b2":
        avg = average[..., 0] if average.ndim == 3 else average
        return r3g3b2_to_gray(avg.reshape(-1)).reshape(avg.shape)
    if average.ndim == 3:
        return average[..., 0]
    return average
