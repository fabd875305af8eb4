"""Fish <-> blob assignment over a sparse probability graph.

Counterpart of ``trex_tpu/track/matching.py`` (the reference's
Match::PairedProbabilities + Match::PairingGraph, PairingGraph.h:106-230)
for the match modes the port's engines accept:

- ``approximate``: blobs in index order each take their best still-free
  fish (PairingGraph.cpp:1141-1193);
- ``hungarian``: optimal assignment per connected clique (Kuhn-Munkres
  over probabilities scaled to integers, PairingGraph.cpp:1017);
- ``tree``: branch-and-bound maximising the sum of p over degree-sorted
  fish (PairingGraph.cpp:1196-1275), greedy on timeout;
- ``automatic``: per clique the tree search for up to 8 fish, the
  Hungarian optimum otherwise (Tracker.cpp:1805-1812);
- ``benchmark``: hungarian, tree and approximate on the whole frame,
  each timed, their disagreements reported, the hungarian assignment
  kept (PairingGraph.cpp:1277-1370). Only the object Tracker takes it.
"""
from __future__ import annotations

import time as _time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
from scipy.optimize import linear_sum_assignment


class PairedProbabilities:
    """Sparse fish -> blob probability edges: ``edges[fi]`` lists
    ``(bi, p)`` by fish slot; slots map to ids through ``fish(fi)`` and
    ``blob(bi)``."""

    def __init__(self):
        self._fish: list = []
        self._fish_index: dict = {}
        self._blobs: list = []
        self._blob_index: dict = {}
        self.edges: dict[int, list[tuple[int, float]]] = defaultdict(list)

    def add(self, fish, blob, p: float):
        fi = self._fish_index.setdefault(fish, len(self._fish))
        if fi == len(self._fish):
            self._fish.append(fish)
        bi = self._blob_index.setdefault(blob, len(self._blobs))
        if bi == len(self._blobs):
            self._blobs.append(blob)
        self.edges[fi].append((bi, float(p)))

    @property
    def n_fish(self):
        return len(self._fish)

    @property
    def n_blobs(self):
        return len(self._blobs)

    def fish(self, i):
        return self._fish[i]

    def blob(self, i):
        return self._blobs[i]

    def probability(self, fi: int, bi: int) -> float:
        for b, p in self.edges.get(fi, ()):
            if b == bi:
                return p
        return 0.0

    def max_prob(self) -> float:
        return max((p for es in self.edges.values() for _, p in es),
                   default=0.0)

    def blob_edges(self) -> dict[int, list[tuple[int, float]]]:
        out = defaultdict(list)
        for fi, es in self.edges.items():
            for bi, p in es:
                out[bi].append((fi, p))
        return out

    def cliques(self) -> list[tuple[list[int], list[int]]]:
        """Connected components of the bipartite graph as
        [(fish slots, blob slots), ...]; a fish without edges is a
        clique of its own with no blobs."""
        parent = list(range(self.n_fish + self.n_blobs))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

        nf = self.n_fish
        for fi, es in self.edges.items():
            for bi, _ in es:
                union(fi, nf + bi)
        groups: dict[int, tuple[list, list]] = defaultdict(lambda: ([], []))
        for fi in range(nf):
            groups[find(fi)][0].append(fi)
        for bi in range(self.n_blobs):
            groups[find(nf + bi)][1].append(bi)
        return list(groups.values())


@dataclass
class MatchResult:
    pairings: dict = field(default_factory=dict)  # blob -> fish
    improvements_made: int = 0
    mode: str = "automatic"


def _greedy_on(paired: PairedProbabilities, fish_sub=None,
               blob_sub=None) -> dict[int, int]:
    """Blobs in index order each take the highest-probability still
    unused fish (first maximum in fish-index order), optionally within
    a clique's fish and blobs."""
    col = paired.blob_edges()
    used_fish = set()
    out = {}
    blob_ids = sorted(col) if blob_sub is None else sorted(
        b for b in col if b in blob_sub)
    allowed = None if fish_sub is None else set(fish_sub)
    for bi in blob_ids:
        best_p, best_f = 0.0, None
        for fi, p in sorted(col[bi]):
            if fi in used_fish or (allowed is not None
                                   and fi not in allowed):
                continue
            if p > best_p:
                best_p, best_f = p, fi
        if best_f is not None:
            used_fish.add(best_f)
            out[bi] = best_f
    return out


def _hungarian_on(paired: PairedProbabilities, fish_idx: list[int],
                  blob_idx: list[int]) -> dict[int, int]:
    """Optimal assignment on one clique maximising the sum of p, over
    probabilities scaled to the reference's integer grid (1e7) so that
    ties break as there."""
    if not fish_idx or not blob_idx:
        return {}
    fish_pos = {f: i for i, f in enumerate(fish_idx)}
    blob_pos = {b: i for i, b in enumerate(blob_idx)}
    scale = 10000000.0
    cost = np.zeros((len(fish_idx), len(blob_idx)), np.int64)
    for fi in fish_idx:
        for bi, p in paired.edges.get(fi, ()):
            if bi in blob_pos:
                cost[fish_pos[fi], blob_pos[bi]] = int(p * scale)
    rows, cols = linear_sum_assignment(cost, maximize=True)
    return {blob_idx[c]: fish_idx[r] for r, c in zip(rows, cols)
            if cost[r, c] > 0}


def _tree2_on(edges: dict, order: list) -> dict[int, int]:
    """Exact solver for two-fish cliques in the tree search's leaf order
    (first maximum, row-major over [f1 options by p desc + unassigned]
    x [f2 options by p desc + unassigned])."""
    f1, f2 = order
    o1 = sorted(edges[f1], key=lambda e: -e[1]) + [(-1, 0.0)]
    o2 = sorted(edges[f2], key=lambda e: -e[1]) + [(-2, 0.0)]
    best = -1.0
    bi = bj = -1
    for b1, p1 in o1:
        for b2, p2 in o2:
            if b1 == b2:
                continue
            t = p1 + p2
            if t > best:
                best = t
                bi, bj = b1, b2
    out = {}
    if bi >= 0:
        out[bi] = f1
    if bj >= 0:
        out[bj] = f2
    return out


def _tree_on(paired: PairedProbabilities, fish_idx: list[int],
             blob_idx: list[int],
             time_budget: float = 0.5) -> Optional[dict[int, int]]:
    """Branch-and-bound over degree-sorted fish maximising the sum of p.
    Returns None when `time_budget` seconds run out."""
    bset = set(blob_idx)
    edges = {fi: [(bi, p) for bi, p in paired.edges.get(fi, ())
                  if bi in bset] for fi in fish_idx}
    order = sorted(fish_idx, key=lambda fi: len(edges[fi]))
    if len(order) == 2:
        return _tree2_on(edges, order)
    options_of = [sorted(edges[fi], key=lambda e: -e[1]) for fi in order]
    # upper bound of each suffix: the sum of each fish's best p
    best_p = [o[0][1] if o else 0.0 for o in options_of]
    suffix = np.concatenate([np.cumsum(best_p[::-1])[::-1], [0.0]])
    deadline = _time.perf_counter() + time_budget
    best = {"sum": -1.0, "assign": {}}
    used: dict[int, int] = {}
    nodes = [0]

    def rec(i: int, acc: float):
        nodes[0] += 1
        if nodes[0] % 256 == 0 and _time.perf_counter() > deadline:
            raise TimeoutError
        if acc + suffix[i] <= best["sum"]:
            return
        if i == len(order):
            if acc > best["sum"]:
                best["sum"] = acc
                best["assign"] = dict(used)
            return
        fi = order[i]
        for bi, p in options_of[i]:
            if bi in used:
                continue
            used[bi] = fi
            rec(i + 1, acc + p)
            del used[bi]
        rec(i + 1, acc)  # the fish stays unassigned

    try:
        rec(0, 0.0)
    except TimeoutError:
        return None
    return dict(best["assign"])


@dataclass
class BenchmarkStats:
    """Per-algorithm accumulation for match_mode=benchmark
    (PairingGraph.cpp `benchmarks` map :1277)."""
    time_acc: float = 0.0
    samples: int = 0


BENCHMARKS: dict[str, BenchmarkStats] = {}
_bench_counter = [0]


def benchmark_report() -> list[str]:
    """Per-algorithm mean wall time, the lines the reference prints
    every 100 benchmark frames (PairingGraph.cpp:1282-1288)."""
    return [
        f"{name}: {st.time_acc / max(1, st.samples) * 1000:.3f}ms "
        f"({st.samples} samples)"
        for name, st in sorted(BENCHMARKS.items())]


def reset_benchmarks():
    BENCHMARKS.clear()
    _bench_counter[0] = 0


def _match_benchmark(paired: PairedProbabilities, result: MatchResult,
                     time_budget: float) -> dict[int, int]:
    """benchmark mode (PairingGraph.cpp:1277-1370): run hungarian,
    tree and approximate on the full frame, accumulate per-algorithm
    wall time, print the periodic report, warn with per-fish diffs on
    disagreement; the hungarian assignment is the one returned."""
    runs: dict[str, dict[int, int]] = {}
    for name in ("hungarian", "tree", "approximate"):
        t0 = _time.perf_counter()
        runs[name] = _match_raw(paired, name, time_budget)
        st = BENCHMARKS.setdefault(name, BenchmarkStats())
        st.time_acc += _time.perf_counter() - t0
        st.samples += 1
    _bench_counter[0] += 1
    if _bench_counter[0] % 100 == 0:
        for line in benchmark_report():
            print(f"[match benchmark] {line}")
    # per-fish comparison: fish -> blob maps per algorithm
    by_fish = {name: {f: b for b, f in raw.items()}
               for name, raw in runs.items()}
    disagreements = []
    for fi in range(paired.n_fish):
        picks = {name: by_fish[name].get(fi) for name in by_fish}
        if len(set(picks.values())) > 1:
            disagreements.append((fi, picks))
    if disagreements:
        result.improvements_made = len(disagreements)
        probs = {fi: dict(paired.edges.get(fi, ()))
                 for fi, _ in disagreements}
        for fi, picks in disagreements:
            parts = []
            for name, bi in sorted(picks.items()):
                p = probs[fi].get(bi, 0.0) if bi is not None else 0.0
                blob = paired.blob(bi) if bi is not None else None
                parts.append(f"({name}) {blob} ({p:.4f})")
            print(f"[match benchmark] warning: individual "
                  f"{paired.fish(fi)}: " + " != ".join(parts))
    return runs["hungarian"]


def _match_raw(paired: PairedProbabilities, mode: str,
               time_budget: float) -> dict[int, int]:
    """Whole-frame blob slot -> fish slot assignment of one algorithm,
    clique by clique (``hungarian`` or ``tree``; ``approximate`` over
    the whole frame)."""
    if mode == "approximate":
        return _greedy_on(paired)
    raw: dict[int, int] = {}
    for fish_idx, blob_idx in paired.cliques():
        if not blob_idx:
            continue
        if mode == "hungarian":
            sub = _hungarian_on(paired, fish_idx, blob_idx)
        else:
            sub = _tree_on(paired, fish_idx, blob_idx, time_budget)
            if sub is None:
                sub = _greedy_on(paired, fish_idx, set(blob_idx))
        raw.update(sub)
    return raw


def match(paired: PairedProbabilities, mode: str = "automatic",
          time_budget: float = 0.5) -> MatchResult:
    """Assign blobs to fish with the matcher of `mode`, clique by
    clique."""
    result = MatchResult(mode=mode)
    raw: dict[int, int] = {}
    if mode == "approximate":
        raw = _greedy_on(paired)
    elif mode == "benchmark":
        raw = _match_benchmark(paired, result, time_budget)
    elif mode in ("hungarian", "tree", "automatic"):
        for fish_idx, blob_idx in paired.cliques():
            if not blob_idx:
                continue
            # trivial cliques: the optimum is the single best edge, in
            # _tree_on's order (first maximum)
            if mode in ("tree", "automatic"):
                if len(fish_idx) == 1:
                    fi = fish_idx[0]
                    bset = set(blob_idx)
                    best_b, best_p = None, -1.0
                    for bi, p in paired.edges.get(fi, ()):
                        if bi in bset and p > best_p:
                            best_b, best_p = bi, p
                    if best_b is not None:
                        raw[best_b] = fi
                    continue
                if len(blob_idx) == 1:
                    bi = blob_idx[0]
                    best_f, best_p = None, -1.0
                    for fi in fish_idx:
                        for b, p in paired.edges.get(fi, ()):
                            if b == bi and p > best_p:
                                best_f, best_p = fi, p
                    if best_f is not None:
                        raw[bi] = best_f
                    continue
            if mode == "hungarian":
                sub = _hungarian_on(paired, fish_idx, blob_idx)
            elif mode == "tree":
                sub = _tree_on(paired, fish_idx, blob_idx, time_budget)
                if sub is None:
                    sub = _greedy_on(paired, fish_idx, set(blob_idx))
            elif len(fish_idx) <= 8:  # automatic
                sub = _tree_on(paired, fish_idx, blob_idx,
                               min(time_budget, 0.05))
                if sub is None:
                    sub = _hungarian_on(paired, fish_idx, blob_idx)
            else:
                sub = _hungarian_on(paired, fish_idx, blob_idx)
            raw.update(sub)
    else:
        raise ValueError(f"unknown match_mode {mode!r}")
    for bi, fi in raw.items():
        result.pairings[paired.blob(bi)] = paired.fish(fi)
    return result
