"""Class-id prediction filter for detections (`detect_only_classes`).

The port of ``trex_tpu/detect/prediction_filter.py``, unchanged: it
re-creates track::detect::PredictionFilter
(core/DetectionTypes.h:26-49, DetectionTypes.cpp:11-86): a list of
allowed class ids, parseable from strings that mix numeric ids and
class NAMES (resolved case-insensitively against `detect_classes`),
with a leading ``-`` negating the set against the full class map.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def _parse_parts(sv: str) -> list[str]:
    sv = sv.strip()
    if sv.startswith("[") and sv.endswith("]"):
        sv = sv[1:-1]
    return [p.strip().strip('"').strip("'")
            for p in sv.split(",") if p.strip()]


@dataclass
class PredictionFilter:
    detect_only: list[int] = field(default_factory=list)
    inverted_from: Optional[list[int]] = None

    # -- queries (DetectionTypes.cpp:11-17) -----------------------------
    def allowed(self, clid: int) -> bool:
        if self.inverted_from is not None:
            return clid not in self.inverted_from
        if not self.detect_only:
            return True
        return clid in self.detect_only

    def __bool__(self) -> bool:
        return bool(self.detect_only) or self.inverted_from is not None

    def __contains__(self, clid: int) -> bool:
        return clid in self.detect_only

    # -- parsing ---------------------------------------------------------
    @staticmethod
    def class_id_for(search: str, detect_classes: dict) -> Optional[int]:
        s = search.lower()
        for cid, name in (detect_classes or {}).items():
            if str(name).lower() == s:
                return int(cid)
        return None

    @staticmethod
    def invert(ids: list[int], detect_classes: dict) -> list[int]:
        out = []
        for cid in (detect_classes or {}):
            cid = int(cid)
            if cid not in ids and cid not in out:
                out.append(cid)
        return out

    @classmethod
    def from_str(cls, sv: str,
                 detect_classes: Optional[dict] = None
                 ) -> "PredictionFilter":
        detect_classes = detect_classes or {}
        sv = str(sv).strip()
        invert = sv.startswith("-")
        if invert:
            sv = sv[1:]
        only: list[int] = []
        for part in _parse_parts(sv):
            if part.lstrip("+").isdigit():
                only.append(int(part))
            else:
                cid = cls.class_id_for(part, detect_classes)
                if cid is None:
                    raise ValueError(f"Unknown detection class: {part!r}")
                if cid not in only:
                    only.append(cid)
        if invert:
            return cls(detect_only=cls.invert(only, detect_classes),
                       inverted_from=only)
        return cls(detect_only=only)

    def to_str(self) -> str:
        if self.inverted_from is not None:
            return "-[" + ",".join(str(i) for i in self.inverted_from) + "]"
        return "[" + ",".join(str(i) for i in self.detect_only) + "]"

    __str__ = to_str


def filter_from_settings(settings) -> Optional[PredictionFilter]:
    """Build the filter from `detect_only_classes` (+ `detect_classes`
    for name resolution); None/empty -> no filtering."""
    raw = settings["detect_only_classes"]
    if raw is None or raw == "" or raw == []:
        return None
    classes = settings["detect_classes"]
    cmap = {}
    if isinstance(classes, dict):
        cmap = {int(k): str(v) for k, v in classes.items()}
    if isinstance(raw, PredictionFilter):
        return raw
    if isinstance(raw, str):
        return PredictionFilter.from_str(raw, cmap)
    if isinstance(raw, (list, tuple, set)):
        out = []
        for x in raw:
            if isinstance(x, str) and not str(x).lstrip("+").isdigit():
                cid = PredictionFilter.class_id_for(x, cmap)
                if cid is None:
                    raise ValueError(f"Unknown detection class: {x!r}")
                if cid not in out:
                    out.append(cid)
            else:
                out.append(int(x))
        return PredictionFilter(detect_only=out)
    raise ValueError(f"cannot parse detect_only_classes {raw!r}")
