"""VINetwork facade: the identity-network lifecycle API (counterpart of
``trex_tpu/ml/vi_facade.py``).

Re-creates Python::VINetwork (reference ml/VisualIdentification.h:16-120):
train(data, mode in {Restart, Apply, Continue, Accumulate, LoadWeights}),
probabilities(images) -> (N, M), weight files <filename>_weights.npz.
The network runs on the card unless the caller names the CPU
(``device="cpu"``). Of the modes the port has the apply side,
``LoadWeights`` and ``Apply``; the training modes (and the status
callbacks they report through) come with the training slice
(ROADMAP.md A item 3b).
"""
from __future__ import annotations

import enum
from pathlib import Path

import numpy as np

from ..models.training import TRAINING_SLICE


class TrainingMode(enum.Enum):
    Restart = "restart"
    Apply = "apply"
    Continue = "continue"
    Accumulate = "accumulate"
    LoadWeights = "load_weights"


class VINetwork:
    def __init__(self, settings, device=None):
        self.settings = settings
        self.device = device
        self.trainer = None
        self.num_classes = 0

    # ------------------------------------------------------------------
    def _ensure(self, num_classes: int):
        if self.trainer is not None and self.num_classes == num_classes:
            return
        from ..models import VITrainer, build

        s = self.settings
        size = s["individual_image_size"]
        shape = (int(size[1]), int(size[0]), 1)
        model = build(s["visual_identification_version"], num_classes)
        self.trainer = VITrainer(model, num_classes, shape,
                                 device=self.device)
        self.num_classes = num_classes

    def weights_path(self, filename) -> Path:
        return Path(str(filename)).with_name(
            Path(str(filename)).stem + "_weights.npz")

    # ------------------------------------------------------------------
    def train(self, images: np.ndarray, labels: np.ndarray,
              num_classes: int, mode: TrainingMode = TrainingMode.Restart,
              max_epochs=None, weights_file=None):
        if mode == TrainingMode.LoadWeights:
            self._ensure(num_classes)
            self.trainer.load_weights(self.weights_path(weights_file))
            return None
        if mode == TrainingMode.Apply:
            # Apply evaluates the existing network — no weight updates
            # (the reference's TrainingMode::Apply); loads weights when
            # a file is given and none are in memory
            if self.trainer is None and weights_file:
                self._ensure(num_classes)
                self.trainer.load_weights(self.weights_path(weights_file))
            if self.trainer is None:
                raise RuntimeError(
                    "TrainingMode.Apply without a trained network or "
                    "weights_file")
            return None
        raise NotImplementedError(
            f"TrainingMode.{mode.name}: {TRAINING_SLICE}")

    def probabilities(self, images: np.ndarray) -> np.ndarray:
        if self.trainer is None:
            raise RuntimeError("network is not set")
        return self.trainer.predict(images)

    def load_weights(self, path, num_classes: int):
        self._ensure(num_classes)
        self.trainer.load_weights(path)
