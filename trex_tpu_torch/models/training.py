"""The identity network's trainer object (counterpart of the inference
half of ``trex_tpu/models/training.py``'s ``VITrainer``).

Semantics mirrored from the reference:
- predict(): batched softmax probabilities (visual_recognition_torch.py
  :984), in batches of 512 with the tail batch padded, as the JAX
  package pads it to keep one compiled program;
- per-class accuracy;
- checkpoints saved as <filename>_weights.npz in the JAX package's flat
  layout (``vi_params.py``), so either package loads the other's files.

The network runs on the card unless the caller names the CPU
(``device.py``). Training (``train``: the backward pass, augmentation
and the accumulation curriculum) is the training slice's.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from .layers import materialize
from .vi_params import from_flax_arrays, to_flax_arrays

TRAINING_SLICE = ("VITrainer.train comes with the visual-identification "
                  "training slice (ROADMAP.md A item 3b)")


class VITrainer:
    """The identity network's predict side: `model` (from
    ``vi_network.build``) is made for `image_shape` (H, W, C) with
    parameters drawn from `generator` (seeded with `seed` when None) and
    placed on `device` (the card when None)."""

    def __init__(self, model, num_classes: int, image_shape,
                 seed: int = 0, generator: Optional[torch.Generator] = None,
                 device=None):
        self.device = resolve_device(device)
        self.num_classes = num_classes
        self.image_shape = tuple(int(v) for v in image_shape)
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        self.model = materialize(model, self.image_shape, generator,
                                 self.device)

    def train(self, *args, **kwargs):
        raise NotImplementedError(TRAINING_SLICE)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def predict(self, images: np.ndarray, batch_size: int = 512) -> np.ndarray:
        """Softmax probabilities (N, num_classes) of NHWC images (uint8
        or float); the tail batch is padded with zeros to `batch_size`."""
        images = np.asarray(images)
        if images.dtype != np.uint8:
            images = images.astype(np.float32)
        n = len(images)
        out = np.empty((n, self.num_classes), np.float32)
        for s in range(0, n, batch_size):
            chunk = torch.from_numpy(np.ascontiguousarray(
                images[s : s + batch_size]))
            k = len(chunk)
            x = torch.zeros((batch_size, *chunk.shape[1:]),
                            dtype=chunk.dtype, device=self.device)
            x[:k] = chunk.to(self.device)
            logits = self.model(x.permute(0, 3, 1, 2))
            probs = torch.softmax(logits.float(), dim=-1)
            out[s : s + k] = probs[:k].cpu().numpy()
        return out

    def per_class_accuracy(self, images, labels, batch_size=512) -> np.ndarray:
        if images is None or len(images) == 0:
            return np.zeros(self.num_classes)
        probs = self.predict(images, batch_size)
        pred = probs.argmax(axis=-1)
        acc = np.zeros(self.num_classes)
        for c in range(self.num_classes):
            m = labels == c
            acc[c] = (pred[m] == c).mean() if m.sum() else 0.0
        return acc

    # ------------------------------------------------------------------
    def save_weights(self, path):
        """<filename>_weights.npz layout: flat param arrays + meta."""
        arrays = to_flax_arrays(self.model)
        arrays["__meta__"] = np.array([json.dumps({
            "num_classes": self.num_classes,
            "image_shape": self.image_shape,
        })])
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def load_weights(self, path):
        with np.load(path, allow_pickle=False) as data:
            from_flax_arrays(self.model, data)
