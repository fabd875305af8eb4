"""Pixel-grid device detection: batched background subtraction,
connected components and per-blob statistics on the card.

Counterpart of ``trex_tpu/ops/device_pipeline.py``. ``use_pallas=True``
routes the labelling to the hand-written CUDA kernel
(:func:`.cc_device.label_components_vmem`); the flag keeps its name so
callers map one to one.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from .cc_device import (component_stats, label_components,
                        label_components_vmem)


def detect_batch(frames, background, threshold: int,
                 track_threshold: int = 0, absolute: bool = False,
                 max_blobs: int = 512, use_pallas: bool = False,
                 device=None) -> dict:
    """Detect blobs in a batch of frames.

    frames:     (B, H, W) uint8
    background: (H, W) uint8
    threshold:  detect threshold vs background (absolute: |f-b|,
                signed: b-f, darker than background)
    track_threshold: optional second threshold whose per-blob pixel
                count is fused into the same pass

    Returns tensors with one row per blob slot:
      cx, cy  (B, max_blobs) float32 centroids (nan for empty slots)
      count   (B, max_blobs) float32 pixel counts
      track_count (B, max_blobs) float32 recount at track_threshold
      valid   (B, max_blobs) bool
    """
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev)
    background = torch.as_tensor(background, device=dev)
    f = frames.to(torch.int16)
    b = background.to(torch.int16)[None]
    diff = (f - b).abs() if absolute else (b - f)
    mask = (diff >= threshold) & (frames > 0)
    track_mask = ((diff >= track_threshold) & mask).to(torch.uint8) \
        if track_threshold > 0 else mask.to(torch.uint8)
    if use_pallas:
        labels = label_components_vmem(mask)
    else:
        labels = label_components(mask)
    stats = component_stats(labels, track_mask, max_blobs=max_blobs)
    count = stats["count"]
    valid = count > 0
    safe = torch.clamp_min(count, 1.0)
    cx = torch.where(valid, stats["sum_x"] / safe, float("nan"))
    cy = torch.where(valid, stats["sum_y"] / safe, float("nan"))
    return {
        "cx": cx,
        "cy": cy,
        "count": count,
        "track_count": stats["sum_value"],
        "valid": valid,
    }
