"""Fish <-> blob assignment over a sparse probability graph.

Counterpart of ``trex_tpu/track/matching.py`` in the mode the base
configuration reaches, ``match_mode=approximate``: blobs in index order
each take their best still-free fish (the reference's
PairingGraph.cpp:1141-1193). The optimal modes (automatic, hungarian,
tree) are queued in ``ROADMAP.md`` and raise here.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


class PairedProbabilities:
    """Sparse fish -> blob probability edges: ``edges[fi]`` lists
    ``(bi, p)`` by fish slot; slots map to ids through ``fish(fi)`` and
    ``blob(bi)``."""

    def __init__(self):
        self._fish: list = []
        self._blobs: list = []
        self.edges: dict[int, list[tuple[int, float]]] = defaultdict(list)

    def fish(self, i):
        return self._fish[i]

    def blob(self, i):
        return self._blobs[i]

    def blob_edges(self) -> dict[int, list[tuple[int, float]]]:
        out = defaultdict(list)
        for fi, es in self.edges.items():
            for bi, p in es:
                out[bi].append((fi, p))
        return out


@dataclass
class MatchResult:
    pairings: dict = field(default_factory=dict)  # blob -> fish
    improvements_made: int = 0
    mode: str = "approximate"


def _greedy_on(paired: PairedProbabilities) -> dict[int, int]:
    """Blobs in index order each take the highest-probability still
    unused fish (first maximum in fish-index order)."""
    col = paired.blob_edges()
    used_fish = set()
    out = {}
    for bi in sorted(col.keys()):
        best_p, best_f = 0.0, None
        for fi, p in sorted(col[bi]):
            if fi in used_fish:
                continue
            if p > best_p:
                best_p, best_f = p, fi
        if best_f is not None:
            used_fish.add(best_f)
            out[bi] = best_f
    return out


def match(paired: PairedProbabilities,
          mode: str = "approximate") -> MatchResult:
    """Assign blobs to fish with the matcher of `mode`."""
    if mode != "approximate":
        raise ValueError(f"match_mode {mode!r} is not ported yet "
                         "(only 'approximate')")
    result = MatchResult(mode=mode)
    for bi, fi in _greedy_on(paired).items():
        result.pairings[paired.blob(bi)] = paired.fish(fi)
    return result
