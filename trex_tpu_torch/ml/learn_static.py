"""Static-image classifier training (the reference's legacy TF entry
python/learn_static.py: train a categorizer on externally-provided
image/label arrays — used for physical-tag decoding models and other
static datasets, outside the accumulation curriculum).

The training loop, early-stop semantics and weight files are the same
machinery as visual identification (models/training.VITrainer); this
module is the thin dataset-level entry: load arrays (or an npz with
`images`/`labels`), split, train, save `<prefix>_weights.npz`.

Counterpart of ``trex_tpu/ml/learn_static.py``: the network trains on
the card unless the caller names the CPU (``device``)::

    python -m trex_tpu_torch.ml.learn_static dataset.npz --output static
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def load_dataset(path) -> tuple[np.ndarray, np.ndarray]:
    """npz with `images` (N, H, W[, 1]) uint8 + `labels` (N,) int."""
    with np.load(path) as z:
        images = z["images"]
        labels = z["labels"]
    if images.ndim == 3:
        images = images[..., None]
    return images.astype(np.float32), labels.astype(np.int32)


def train_static(images: np.ndarray, labels: np.ndarray,
                 version: str = "v118_3", max_epochs: int = 150,
                 batch_size: int = 128, output_prefix: Optional[str] = None,
                 mesh=None, device=None):
    """Train a classifier on a static dataset; returns (trainer,
    TrainResult). Saves `<output_prefix>_weights.npz` when given.
    `mesh` trains data parallel over its ranks (``VITrainer(mesh=...)``:
    every rank calls this with the same arrays)."""
    from ..models import VITrainer, build

    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int32)
    if images.ndim == 3:
        images = images[..., None]
    # remap sparse/1-based label sets densely (tag ids commonly start
    # at 1; phantom empty classes would pin worst-class accuracy at 0)
    uniq, labels = np.unique(labels, return_inverse=True)
    num_classes = len(uniq)
    model = build(version, num_classes)
    trainer = VITrainer(model, num_classes, images.shape[1:], mesh=mesh,
                        device=device)
    result = trainer.train(images, labels, max_epochs=max_epochs,
                           batch_size=batch_size)
    if output_prefix:
        trainer.save_weights(Path(f"{output_prefix}_weights.npz"))
    return trainer, result


def main(argv=None, device=None):
    """The command line; the network trains on `device` (the card when
    None)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="train a static-image classifier (learn_static)")
    ap.add_argument("dataset", help="npz with images + labels")
    ap.add_argument("--version", default="v118_3")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--output", default="static")
    args = ap.parse_args(argv)
    images, labels = load_dataset(args.dataset)
    trainer, result = train_static(images, labels, args.version,
                                   args.epochs,
                                   output_prefix=args.output,
                                   device=device)
    acc = result.per_class_accuracy
    print(f"trained {result.epochs} epochs; per-class accuracy "
          f"mean {acc.mean():.3f} worst {acc.min():.3f}"
          if acc is not None else f"trained {result.epochs} epochs")


if __name__ == "__main__":
    main()
