"""Edge-boundary guard of the on-device matching.

Counterpart of the part of ``trex_tpu/ops/device_match.py`` that the
greedy matching pass of the tracking scan calls. The auction matcher
(``match_mode`` other than ``approximate``) is ported in a later slice.
"""
from __future__ import annotations

import torch

EDGE_GUARD = 1e-6    # |p - p_min| boundary band -> host


def edge_boundary_marginal(Pmat: torch.Tensor, usable_f: torch.Tensor,
                           valid_b: torch.Tensor, p_min: float,
                           p_err: torch.Tensor) -> torch.Tensor:
    """True when any candidate edge sits within EDGE_GUARD of the p_min
    edge-inclusion boundary (f32 vs host-f64 edge sets could differ).

    `p_err` ((F, B)) widens the band per edge by a bound on
    |p_f32 - p_f64| over the same carry bits."""
    band = (Pmat - p_min).abs() <= EDGE_GUARD + p_err
    return (band & usable_f[:, None] & valid_b[None, :]).any()
