"""State carried across between the JAX package and the port.

The port has no weights: its state is the tracker carry and the
tracking parameters. Both packages pack the carry into the same 1-D
float32 layout (``carry_to_vec``), so a chunk can be resumed in the
port from a JAX carry, and the other way round.

Tracking parameters come from any settings mapping:
``device_tracker.params_from_settings`` accepts the ``dict`` built from
the JAX ``Settings`` object, e.g. ``{k: s[k] for k in DEFAULTS}``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.device_tracker import TrackParams, _carry_from_vec, carry_to_vec


def carry_from_jax(vec: np.ndarray, P: TrackParams, device=None) -> dict:
    """Packed carry vector (the JAX package's ``carry_to_vec`` layout)
    -> the port's carry dict of tensors on `device`."""
    dev = resolve_device(device)
    return _carry_from_vec(
        torch.as_tensor(np.asarray(vec, np.float32), device=dev), P)


def carry_to_numpy(carry: dict) -> np.ndarray:
    """The port's carry dict -> packed float32 vector in the JAX layout."""
    return carry_to_vec(carry)
