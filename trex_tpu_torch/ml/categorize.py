"""Categorization's label store (counterpart of the ``DataStore`` and
``RangedLabel`` of ``trex_tpu/ml/categorize.py``).

The ranged category labels per (individual, tracklet) of the
reference's CategorizeDatastore (tracking/CategorizeDatastore.{h,cpp},
ranged_label :199), which `.results` files carry and the `category`
export fields read. The classifier that fills it (``Categorizer``)
comes with the visual-identification training slice (ROADMAP.md A
item 3b).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
