"""Categorization: user-defined visual classes (e.g. male/female)
(counterpart of ``trex_tpu/ml/categorize.py``).

Re-creates the reference's Categorize subsystem:
- DataStore of ranged labels per (individual, tracklet)
  (tracking/CategorizeDatastore.{h,cpp}, ranged_label :199), which
  `.results` files carry and the `category` export fields read;
- a small MLP trained on labeled crops (trex_learn_category.py:18-153),
  on the card unless the caller names the CPU (``device``);
- apply: per-tracklet predicted label, used as a matching veto
  (track_consistent_categories; prefilter track_only_categories).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.crops import crops_for_individual


@dataclass
class RangedLabel:
    fid: int
    start: int
    end: int
    label: int


class DataStore:
    """Ranged category labels, queryable per (frame, individual)."""

    def __init__(self, categories: list[str]):
        self.categories = list(categories)
        self._ranged: list[RangedLabel] = []
        # per-frame blob-id labels (CategorizeDatastore.cpp keys ranged
        # labels by pv::bid): frame -> {blob_id: label}. This is the
        # index the matching veto reads (track_consistent_categories;
        # Tracker.cpp:1126-1134 builds blob_labels from it)
        self._blob_labels: dict[int, dict[int, int]] = {}

    def label_id(self, name: str) -> int:
        return self.categories.index(name)

    def label_name(self, lid: int) -> str:
        return self.categories[lid]

    def set_ranged_label(self, fid: int, start: int, end: int, label):
        if isinstance(label, str):
            label = self.label_id(label)
        self._ranged.append(RangedLabel(fid, start, end, int(label)))

    def ranged_label(self, frame: int, fid: int) -> Optional[int]:
        for r in reversed(self._ranged):
            if r.fid == fid and r.start <= frame <= r.end:
                return r.label
        return None

    def labeled_ranges(self) -> list[RangedLabel]:
        return list(self._ranged)

    def set_blob_label(self, frame: int, blob_id: int, label):
        if isinstance(label, str):
            label = self.label_id(label)
        self._blob_labels.setdefault(int(frame), {})[int(blob_id)] = \
            int(label)

    def blob_label(self, frame: int, blob_id: int) -> Optional[int]:
        """Per-blob label (DataStore::ranged_label(Frame_t, pv::bid),
        CategorizeDatastore.cpp:199)."""
        return self._blob_labels.get(int(frame), {}).get(int(blob_id))

    def index_individual(self, ind, start: int, end: int, label):
        """Record the blob ids an individual owned over [start, end]
        under `label`, making them queryable by blob_label()."""
        if isinstance(label, str):
            label = self.label_id(label)
        for f in range(int(start), int(end) + 1):
            b = ind.basic_stuff(f)
            if b is not None:
                self.set_blob_label(f, b.blob.blob_id, label)

    def clear(self):
        self._ranged.clear()
        self._blob_labels.clear()


class Categorizer:
    def __init__(self, settings, categories: list[str], device=None):
        from ..models import SmallMLP
        from ..models.training import VITrainer

        self.settings = settings
        self.store = DataStore(categories)
        size = settings["individual_image_size"]
        self.image_shape = (int(size[1]), int(size[0]), 1)
        self.trainer = VITrainer(
            SmallMLP(num_classes=len(categories)), len(categories),
            self.image_shape,
            learning_rate=settings["gpu_learning_rate"], device=device)

    def _collect_labeled(self, tracker):
        images, labels = [], []
        # categories_train_min_tracklet_length: labeled ranges shorter
        # than this never become training samples
        # (CategorizeDatastore.cpp:312 sample() min_len gate)
        min_len = int(self.settings[
            "categories_train_min_tracklet_length"] or 0)
        for r in self.store.labeled_ranges():
            ind = tracker.individuals.get(r.fid)
            if ind is None:
                continue
            if r.end - r.start + 1 < max(1, min_len):
                continue
            crops, _ = crops_for_individual(
                ind, tracker, self.settings,
                frames=set(range(r.start, r.end + 1)))
            if len(crops):
                images.append(crops)
                labels.append(np.full(len(crops), r.label))
        if not images:
            return (np.zeros((0, *self.image_shape), np.uint8),
                    np.zeros(0, np.int64))
        return np.concatenate(images), np.concatenate(labels)

    def train(self, tracker, max_epochs: int = 50):
        images, labels = self._collect_labeled(tracker)
        if len(images) < 2 * len(self.store.categories):
            raise ValueError("not enough labeled samples to train")
        return self.trainer.train(images, labels, max_epochs=max_epochs,
                                  min_iterations=10)

    def apply(self, tracker, min_tracklet_length: Optional[int] = None):
        """Predict a label for every tracklet long enough; writes ranged
        labels into the store and returns them."""
        s = self.settings
        if min_tracklet_length is None:
            min_tracklet_length = int(
                s["categories_apply_min_tracklet_length"])
        applied = []
        for fid, ind in sorted(tracker.individuals.items()):
            for t0, t1 in ind.tracklets:
                if t1 - t0 + 1 < max(1, min_tracklet_length):
                    continue
                crops, _ = crops_for_individual(
                    ind, tracker, self.settings,
                    frames=set(range(t0, t1 + 1)))
                if not len(crops):
                    continue
                probs = self.trainer.predict(crops).mean(axis=0)
                label = int(probs.argmax())
                self.store.set_ranged_label(fid, t0, t1, label)
                # per-blob index: what the track_consistent_categories
                # matching veto queries (Tracker.cpp:1126-1134)
                self.store.index_individual(ind, t0, t1, label)
                applied.append(RangedLabel(fid, t0, t1, label))
        return applied
