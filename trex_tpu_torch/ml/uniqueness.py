"""Uniqueness metric for visual identification (counterpart of
``trex_tpu/ml/uniqueness.py``, host numpy).

Exact re-implementation of Accumulation::calculate_uniqueness
(reference ui/Accumulation.cpp:767-880): per frame, the fraction of
distinct predicted identities among that frame's samples, weighted by a
logistic regression of the mean best probability; plus good_uniqueness()
(:881-887), the acceptance threshold used by the accumulation loop.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np


def logistic_regression(x: np.ndarray) -> np.ndarray:
    normal = 1 + math.exp(-math.pi)
    return 1.0 / (1.0 + np.exp(-x * math.pi)) * normal


def calculate_uniqueness(predictions: np.ndarray,
                         map_indexes: Mapping[int, tuple],
                         num_individuals: int):
    """predictions: (M, N) probabilities for M sample images over N ids;
    map_indexes: frame -> (start, end) row range of that frame's samples.

    Returns (good_ratio, per_frame_uniqueness, mean_percent,
    per_identity_uniqueness)."""
    good = bad = 0
    percentages = 0.0
    unique_percent: dict[int, float] = {}
    per_id_sum = np.zeros(num_individuals)
    per_id_n = np.zeros(num_individuals)
    for frame, (start, end) in map_indexes.items():
        rows = predictions[start:end]
        n = end - start
        if n <= 0:
            # the reference counts an empty range as a GOOD frame
            # (unique_ids.size() == range.length() == 0,
            # Accumulation.cpp:822)
            unique_percent[frame] = 0.0
            good += 1
            continue
        max_p = rows.max(axis=1)
        max_id = rows.argmax(axis=1)
        valid = max_p > 0
        ids = max_id[valid]
        unique_ids = set(ids.tolist())
        probs: dict[int, float] = {}
        for i, p in zip(ids.tolist(), max_p[valid].tolist()):
            probs[i] = max(probs.get(i, 0.0), p)
        p = len(unique_ids) / float(n)
        for i, v in probs.items():
            per_id_sum[i] += v
            per_id_n[i] += 1
        if probs:
            accum = sum(probs.values()) / len(probs)
            p = float(logistic_regression(np.float64(accum))) * p
        unique_percent[frame] = float(p)
        percentages += p
        if len(unique_ids) == n:
            good += 1
        else:
            bad += 1
    total = good + bad
    per_identity = np.divide(per_id_sum, per_id_n,
                             out=np.zeros_like(per_id_sum),
                             where=per_id_n > 0)
    mean_percent = percentages / len(unique_percent) if unique_percent else 0.0
    return (good / total if total else 0.0, unique_percent,
            mean_percent, per_identity)


def good_uniqueness(num_individuals: int) -> float:
    """Acceptance threshold (Accumulation.cpp:881-887)."""
    if num_individuals < 3:
        return 0.95
    return max(0.9, (num_individuals - 0.5) / num_individuals)
