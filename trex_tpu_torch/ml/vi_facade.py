"""VINetwork facade: the identity-network lifecycle API.

Re-creates Python::VINetwork (reference ml/VisualIdentification.h:16-120):
train(data, mode in {Restart, Apply, Continue, Accumulate, LoadWeights}),
probabilities(images) -> (N, M), weight files <filename>_weights.npz,
status callbacks. The reference serialized all NN traffic through one
embedded-Python thread (python/PythonWrapper.h:40-42); here the network
is in-process torch, so calls are direct. Counterpart of
``trex_tpu/ml/vi_facade.py``: the network trains and predicts on the
card unless the caller names the CPU (``device="cpu"``).
"""
from __future__ import annotations

import enum
from pathlib import Path
from typing import Callable, Optional

import numpy as np


class TrainingMode(enum.Enum):
    Restart = "restart"
    Apply = "apply"
    Continue = "continue"
    Accumulate = "accumulate"
    LoadWeights = "load_weights"


class VINetwork:
    _instance: Optional["VINetwork"] = None

    def __init__(self, settings, device=None):
        self.settings = settings
        self.device = device
        self.trainer = None
        self.num_classes = 0
        self.status_callbacks: list[Callable[[str], None]] = []

    @classmethod
    def instance(cls, settings, device=None) -> "VINetwork":
        if cls._instance is None or cls._instance.settings is not settings:
            cls._instance = cls(settings, device)
        return cls._instance

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
                                 learning_rate=s["gpu_learning_rate"],
                                 device=self.device)
        self.num_classes = num_classes

    def _emit(self, msg: str):
        for cb in self.status_callbacks:
            cb(msg)

    def weights_path(self, filename) -> Path:
        return Path(str(filename)).with_name(
            Path(str(filename)).stem + "_weights.npz")

    # ------------------------------------------------------------------
    def train(self, images: np.ndarray, labels: np.ndarray,
              num_classes: int, mode: TrainingMode = TrainingMode.Restart,
              max_epochs: Optional[int] = None,
              weights_file=None):
        s = self.settings
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
        if mode == TrainingMode.Restart:
            self.trainer = None
        self._ensure(num_classes)
        self._emit(f"training {len(images)} samples ({mode.value})")
        res = self.trainer.train(
            images, labels,
            max_epochs=max_epochs or int(s["gpu_max_epochs"]),
            min_iterations=int(s["gpu_min_iterations"]),
            augment=bool(s.get("vi_train_augment", False)))
        if weights_file:
            self.trainer.save_weights(self.weights_path(weights_file))
        return res

    def probabilities(self, images: np.ndarray) -> np.ndarray:
        if self.trainer is None:
            raise RuntimeError("network is not set")
        return self.trainer.predict(images)

    def load_weights(self, path, num_classes: int):
        self._ensure(num_classes)
        self.trainer.load_weights(path)

    def save_weights(self, path):
        if self.trainer is None:
            raise RuntimeError("network is not set")
        self.trainer.save_weights(path)
