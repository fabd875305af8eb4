"""FOI — "frames of interest" event stream (reference core/FOI.{h,cpp}).

Named event channels (e.g. "split_up", "correcting", warnings) with
per-frame ranges and affected identity sets; consumed by timelines and
the auto-correction pass. Counterpart of ``trex_tpu/track/foi.py``."""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterable, Optional


@dataclass(frozen=True)
class FOI:
    start: int
    end: int
    name: str
    fdx: frozenset = frozenset()
    bdx: frozenset = frozenset()

    def overlaps(self, frame: int) -> bool:
        return self.start <= frame <= self.end


class FOIStore:
    """Global registry of frames-of-interest by channel name."""

    def __init__(self):
        self._lock = threading.RLock()  # add() calls name_id() under lock
        self._by_name: dict[str, list[FOI]] = {}
        self._ids: dict[str, int] = {}
        self._callbacks: list = []

    def name_id(self, name: str) -> int:
        with self._lock:
            if name not in self._ids:
                self._ids[name] = len(self._ids)
            return self._ids[name]

    def add(self, name: str, start: int, end: Optional[int] = None,
            fdx: Iterable[int] = (), bdx: Iterable[int] = ()) -> FOI:
        foi = FOI(start, end if end is not None else start, name,
                  frozenset(fdx), frozenset(bdx))
        with self._lock:
            self.name_id(name)
            lst = self._by_name.setdefault(name, [])
            # merge with the previous entry when contiguous with the same ids
            if lst and lst[-1].end + 1 >= foi.start \
                    and lst[-1].fdx == foi.fdx:
                merged = FOI(min(lst[-1].start, foi.start),
                             max(lst[-1].end, foi.end), name,
                             foi.fdx, lst[-1].bdx | foi.bdx)
                lst[-1] = merged
                foi = merged
            else:
                lst.append(foi)
            cbs = list(self._callbacks)
        for cb in cbs:
            cb(foi)
        return foi

    def foi(self, name: str) -> list[FOI]:
        with self._lock:
            return list(self._by_name.get(name, []))

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._ids.keys())

    def between(self, name: str, start: int, end: int) -> list[FOI]:
        return [f for f in self.foi(name)
                if not (f.end < start or f.start > end)]

    def on_add(self, cb):
        self._callbacks.append(cb)

    def clear(self, name: Optional[str] = None):
        with self._lock:
            if name is None:
                self._by_name.clear()
            else:
                self._by_name.pop(name, None)
