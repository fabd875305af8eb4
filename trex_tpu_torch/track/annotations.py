"""Human annotations: per-frame labeled boxes / poses / segmentations.

Counterpart of ``trex_tpu/track/annotations.py`` (track::Annotation /
AnnotationMap, reference core/annotation.{h,cpp}): annotations
serialize to the settings layer's string form `[clid,type,points]`,
keyed per frame, and convert to training rows for the detection models;
`export_annotations` writes the `track_annotations` map.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np


class AnnotationType(enum.IntEnum):
    BOX = 0
    POSE = 1
    SEGMENTATION = 2


@dataclass
class Annotation:
    clid: int = 0
    type: AnnotationType = AnnotationType.BOX
    points: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float32))
    uid: int = 0

    def to_str(self) -> str:
        pts = ",".join(f"[{float(x)},{float(y)}]" for x, y in self.points)
        return f"[{self.clid},{int(self.type)},[{pts}]]"

    @classmethod
    def from_str(cls, text: str) -> "Annotation":
        from ..config.metaparse import parse_value

        parts = parse_value(text)
        if not isinstance(parts, list) or len(parts) != 3:
            raise ValueError(f"invalid Annotation string: {text!r}")
        clid, type_, points = parts
        return cls(clid=int(clid),
                   type=AnnotationType(max(0, min(2, int(type_)))),
                   points=np.asarray(points, np.float32).reshape(-1, 2))

    def bounds(self):
        if len(self.points) == 0:
            return (0.0, 0.0, 0.0, 0.0)
        x0, y0 = self.points.min(axis=0)
        x1, y1 = self.points.max(axis=0)
        return (float(x0), float(y0), float(x1 - x0), float(y1 - y0))


class AnnotationMap:
    """frame -> [Annotation] with (de)serialization to settings text."""

    def __init__(self):
        self.by_frame: dict[int, list[Annotation]] = {}
        self._next_uid = 1

    def add(self, frame: int, annotation: Annotation) -> Annotation:
        annotation.uid = self._next_uid
        self._next_uid += 1
        self.by_frame.setdefault(frame, []).append(annotation)
        return annotation

    def remove(self, frame: int, uid: int) -> bool:
        lst = self.by_frame.get(frame, [])
        kept = [a for a in lst if a.uid != uid]
        if len(kept) != len(lst):
            if kept:
                self.by_frame[frame] = kept
            else:
                self.by_frame.pop(frame, None)
            return True
        return False

    def at(self, frame: int) -> list[Annotation]:
        return list(self.by_frame.get(frame, []))

    def to_dict(self) -> dict:
        return {str(f): [a.to_str() for a in lst]
                for f, lst in self.by_frame.items()}

    @classmethod
    def from_dict(cls, data: dict) -> "AnnotationMap":
        self = cls()
        for f, lst in (data or {}).items():
            for text in lst:
                self.add(int(f), Annotation.from_str(text))
        return self

    def training_rows(self) -> Iterable[tuple]:
        """(frame, clid, x0, y0, x1, y1) rows for detector fine-tuning."""
        for f, lst in sorted(self.by_frame.items()):
            for a in lst:
                x, y, w, h = a.bounds()
                yield (f, a.clid, x, y, x + w, y + h)


def export_annotations(raw_map, output_dir, video_name: str):
    """Write the per-frame annotation map (`track_annotations`) as
    `<name>_annotations.npz`: `rows` (N, 6) [frame, clid, x0, y0, x1,
    y1] bounds + the raw string forms for round-trips."""
    from pathlib import Path

    amap = raw_map if isinstance(raw_map, AnnotationMap) \
        else AnnotationMap.from_dict(raw_map)
    rows = np.asarray(list(amap.training_rows()), np.float64)
    texts = [f"{f}:{a.to_str()}"
             for f, lst in sorted(amap.by_frame.items()) for a in lst]
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    path = output_dir / f"{video_name}_annotations.npz"
    np.savez(path, rows=rows.reshape(-1, 6),
             raw=np.asarray(texts, dtype=object))
    return path
