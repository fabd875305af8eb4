"""Identity-crop normalization (counterpart of ``trex_tpu/ops/crops.py``).

Re-creates the reference's training-image generation
(individual_image_normalization in {none, moments, posture, legacy} —
core/default_config.cpp:1089; implementation ImageExtractor.cpp:155-270 +
commons constraints::diff_image used by TrainingData.cpp:1163):

- diff image: luminance-normalized (background - pixel) values under the
  blob mask
- alignment: rotate by the posture midline transform (posture) or the
  blob's image-moments orientation (moments)
- scale: median-midline-length scaling (posture), `individual_image_scale`
- pad/crop to `individual_image_size` (80x80) centered on the centroid

The JAX package warps each crop with ``cv2.getRotationMatrix2D`` and
``cv2.warpAffine(INTER_LINEAR, borderValue=0)``. The machine with the
card has no OpenCV, so :func:`rotation_matrix` builds cv2's matrix in
float64 and :func:`warp_affine_u8` runs the port's native warp
(``native/warp.cpp``), bit for bit as OpenCV 5.0.0's 8-bit path on an
x86 host with AVX2 (held to cv2 by ``tests/test_torch_crops.py``).

:func:`warp_crops_device` is the batched bilinear resampler of the JAX
package (a jitted program there, B12 in ``ROADMAP.md``), in plain torch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch


def diff_image(blob, background: np.ndarray,
               pad: int = 0) -> tuple[np.ndarray, tuple]:
    """(bg - pixel) luminance difference crop, 0 outside the mask."""
    mask, gray, (ox, oy) = blob.to_dense(pad=pad)
    h, w = gray.shape
    bg = np.zeros_like(gray)
    bh, bw = background.shape[:2]
    ys0, ys1 = max(0, oy), min(bh, oy + h)
    xs0, xs1 = max(0, ox), min(bw, ox + w)
    bg[ys0 - oy : ys1 - oy, xs0 - ox : xs1 - ox] = background[ys0:ys1, xs0:xs1]
    diff = np.clip(bg.astype(np.int16) - gray.astype(np.int16), 0, 255)
    diff = np.where(mask > 0, diff, 0).astype(np.uint8)
    return diff, (ox, oy)


def rotation_matrix(center, angle_deg: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: the centre is a float32 point, the
    angle goes back to radians by ``* (pi / 180)``, libm's cos and sin."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle_deg * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine_u8(src: np.ndarray, m: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpAffine(src, m, dsize, flags=INTER_LINEAR,
    borderValue=0)`` for a 2-D uint8 image, bit for bit."""
    from .labeling import _lib

    tw, th = int(dsize[0]), int(dsize[1])
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 2 or tw <= 0 or th <= 0:
        raise ValueError(f"warp_affine_u8: a 2-D image and a positive size "
                         f"({src.shape}, {dsize})")
    m = np.ascontiguousarray(m, np.float64).reshape(6)
    out = np.empty((th, tw), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    _lib().trex_warp_affine_u8(
        src.ctypes.data_as(u8p), src.shape[0], src.shape[1],
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), tw, th,
        out.ctypes.data_as(u8p))
    return out


def normalized_crop(blob, background: np.ndarray,
                    settings, midline=None,
                    median_midline_length: Optional[float] = None,
                    mode: Optional[str] = None,
                    raw: bool = False) -> np.ndarray:
    """One (H, W) uint8 normalized identity crop."""
    s = settings
    mode = mode or s["individual_image_normalization"]
    size = s["individual_image_size"]
    tw, th = int(size[0]), int(size[1])
    scale = float(s["individual_image_scale"] or 1.0)

    if raw:
        # original-video appearance (tracklet_force_normal_color):
        # the blob's grey pixels instead of the background difference
        _, grey, (ox, oy) = blob.to_dense(pad=2)
        diff = grey
    else:
        diff, (ox, oy) = diff_image(blob, background, pad=2)
    cx, cy = blob.center
    cx -= ox
    cy -= oy

    angle = 0.0
    if mode == "posture" and midline is not None:
        angle = -midline.angle
    elif mode in ("moments", "legacy"):
        angle = -blob.orientation
    if mode == "posture" and midline is not None \
            and median_midline_length and midline.len > 0:
        scale *= median_midline_length / midline.len

    m = rotation_matrix((float(cx), float(cy)), math.degrees(angle), scale)
    m[0, 2] += tw / 2 - cx
    m[1, 2] += th / 2 - cy
    return warp_affine_u8(diff, m, (tw, th))


def crops_for_individual(ind, tracker, settings, frames=None,
                         median_midline_length=None) -> tuple[np.ndarray, np.ndarray]:
    """All normalized crops for one individual: (N, H, W, 1) + frames."""
    s = settings
    if median_midline_length is None:
        lengths = [p.midline_length for p in ind.posture
                   if not math.isnan(p.midline_length)]
        median_midline_length = float(np.median(lengths)) if lengths else None
    out, got = [], []
    for b in ind.basic:
        if frames is not None and b.frame not in frames:
            continue
        post = ind.posture_stuff(b.frame)
        midline = post.midline if post else None
        crop = normalized_crop(b.blob, tracker.background, s,
                               midline=midline,
                               median_midline_length=median_midline_length)
        out.append(crop)
        got.append(b.frame)
    if not out:
        size = s["individual_image_size"]
        return (np.zeros((0, int(size[1]), int(size[0]), 1), np.uint8),
                np.zeros(0, np.int64))
    return (np.stack(out)[..., None], np.asarray(got, np.int64))


def warp_crops_device(images: torch.Tensor, centers: torch.Tensor,
                      angles: torch.Tensor, scales: torch.Tensor,
                      out_hw: tuple = (80, 80)) -> torch.Tensor:
    """Batched rotate+scale+center resampling (bilinear), on the device
    the inputs lie on.

    images: (B, H, W) float; centers: (B, 2) xy; angles: (B,) rad;
    scales: (B,). Returns (B, oh, ow): each output pixel samples the
    source at the centre plus its offset from the output's middle,
    rotated by -angle and divided by the scale; 0 outside the source."""
    oh, ow = out_hw
    B, H, W = images.shape
    dev, dt = images.device, images.dtype
    ys, xs = torch.meshgrid(torch.arange(oh, dtype=dt, device=dev),
                            torch.arange(ow, dtype=dt, device=dev),
                            indexing="ij")
    dx = xs - ow / 2.0
    dy = ys - oh / 2.0
    inv = torch.clamp(scales, min=1e-6)[:, None, None]
    cos = torch.cos(-angles)[:, None, None] / inv
    sin = torch.sin(-angles)[:, None, None] / inv
    sx = centers[:, 0][:, None, None] + cos * dx - sin * dy
    sy = centers[:, 1][:, None, None] + sin * dx + cos * dy
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    flat = images.reshape(B, H * W)

    def gather(yy, xx):
        yy = torch.clamp(yy, 0, H - 1).to(torch.int64)
        xx = torch.clamp(xx, 0, W - 1).to(torch.int64)
        return torch.gather(flat, 1, (yy * W + xx).reshape(B, -1)) \
            .reshape(B, oh, ow)

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    out = (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
           + v10 * (1 - fx) * fy + v11 * fx * fy)
    return torch.where(inside, out, torch.zeros((), dtype=dt, device=dev))
