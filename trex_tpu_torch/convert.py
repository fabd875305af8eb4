"""State carried across between the JAX package and the port.

The port has no weights: its state is the tracker carry and the
tracking parameters. Both packages pack the carry into the same 1-D
float32 layout (``carry_to_vec``), so a chunk can be resumed in the
port from a JAX carry, and the other way round. With
``track_speed_decay < 1`` the tracking section ends with the (F, 7, 5)
motion window [frame, x, y, time, global step] and the (F, 3) accumulated
decay walk [dx, dy, err]: they cross over as ``win`` and ``dacc``. With
posture on, the layout ends with the (F, 2) previous-midline-direction
section, which orients the next chunk's midlines: it crosses over as
``posture_dir``.

Tracking parameters come from any settings mapping:
``device_tracker.params_from_settings`` accepts the ``dict`` built from
the JAX ``Settings`` object, e.g. ``{k: s[k] for k in DEFAULTS}``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.device_tracker import (TrackParams, _carry_from_vec,
                                 _track_vec_size, carry_to_vec,
                                 carry_vec_size)


def carry_from_jax(vec: np.ndarray, P: TrackParams, device=None) -> dict:
    """Packed carry vector (the JAX package's ``carry_to_vec`` layout)
    -> the port's carry dict of tensors on `device`: with decay "win"
    and "dacc", with posture the posture section as "posture_dir" (F,
    2)."""
    dev = resolve_device(device)
    v = torch.as_tensor(np.array(vec, np.float32), device=dev)
    carry = _carry_from_vec(v, P)
    if P.do_posture:
        carry["posture_dir"] = v[_track_vec_size(P):carry_vec_size(P)] \
            .reshape(P.max_fish, 2)
    return carry


def carry_to_numpy(carry: dict) -> np.ndarray:
    """The port's carry dict -> packed float32 vector in the JAX layout
    (the decay sections from "win" and "dacc", the posture section from
    "posture_dir", when the dict has them)."""
    return carry_to_vec(carry)
