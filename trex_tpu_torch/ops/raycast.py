"""Two-layer visual-field projection on the card (PyTorch).

Counterpart of ``trex_tpu/ops/raycast.py`` (the reference's
track::VisualField, tracking/VisualField.{h,cpp}): two eyes per fish,
512 angular bins over a symmetric 130-degree field of view, two depth
layers. Every (eye, point) pair packs its quantised depth and its
owner's positional id into one int32 key, ``(dq << 9) | id``; one flat
``scatter_reduce_(..., "amin")`` over all E*N pairs into E*n_bins
segments gives the nearest point and its id per bin. An integer min does
not depend on the order of the scatter, so ties resolve as in the JAX
package. Layer 1 reduces again with the layer-0 winner at each point's
bin and the eye's own fish excluded.

Depth is quantised to max_d / 8191. The float steps follow the jitted
JAX program on the CPU bit for bit: the distance is ``jnp.hypot``'s
formula ``hi * sqrt(1 + (lo/hi)^2)`` with ``1 + r^2`` rounded once (XLA
fuses it into one multiply-add) and a correctly rounded square root;
``atan2`` on the CPU is the C library's ``atan2f``, which XLA calls;
``mod`` is ``jnp.mod`` (``fmod`` plus the divisor where the signs
differ); and XLA's algebraic simplifier turns ``x / c1 * c2`` into
``x * ((1 / c1) * c2)`` for the bin, the depth level and the decoded
depth, so the port multiplies by the same folded constants. On the card, ``atan2``
is CUDA's, which can put a point near a bin edge into the next bin.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device

FIELD_RESOLUTION = 512
SYMMETRIC_FOV = math.radians(130.0)
INVALID = 3.4e38

_DEPTH_BITS = 13  # 8192 levels
_ID_BITS = 9  # up to 512 fish

_F32 = torch.float32
_I32 = torch.int32


def _c(x: float, ref: torch.Tensor) -> torch.Tensor:
    """`x` as a float32 scalar tensor beside `ref`."""
    return torch.tensor(np.float32(x), dtype=_F32, device=ref.device)


def _div_mul(x: torch.Tensor, c1: float, c2: float = 1.0) -> torch.Tensor:
    """``x / c1 * c2`` as XLA's simplifier rewrites it for constants:
    ``x * ((1 / c1) * c2)``, the factor folded in float32."""
    one = _c(1.0, x)
    return x * (one / _c(c1, x) * _c(c2, x))


def _one_rounding_1p_sq(r: torch.Tensor) -> torch.Tensor:
    """float32 ``1 + r*r`` rounded once, as a fused multiply-add gives it,
    for float32 0 <= r <= 1: r*r is exact in float64, and the float64
    sum, rounded to float32, is the correctly rounded result, because no
    inexact float64 sum lands on a float32 rounding midpoint (checked
    over every float32 r in [0, 1], tests/test_torch_raycast.py)."""
    r64 = r.to(torch.float64)
    return (1.0 + r64 * r64).to(_F32)


def _hypot(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot`` of finite inputs as the jitted program computes it
    (module doc)."""
    a = dx.abs()
    b = dy.abs()
    hi = torch.maximum(a, b)
    lo = torch.minimum(a, b)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    root = torch.sqrt(_one_rounding_1p_sq(r).to(torch.float64)).to(_F32)
    return torch.where(zero, hi, hi * root)


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2: the card's on a CUDA tensor; on a CPU tensor the C
    library's ``atan2f``, which the jitted JAX program calls (ATen's CPU
    atan2 departs from it in the last bit)."""
    if y.device.type != "cpu":
        return torch.atan2(y, x)
    from .labeling import atan2f

    return torch.from_numpy(atan2f(y.numpy(), x.numpy()))


def _mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod``: the truncated remainder, plus `y` where it is nonzero
    and its sign differs from `y`'s."""
    m = torch.fmod(x, y)
    fix = (m != 0) & ((m < 0) != (y < 0))
    return torch.where(fix, m + y, m)


def visual_field(points, point_ids, point_valid, eye_pos, eye_angle,
                 max_d, n_bins: int = FIELD_RESOLUTION, device=None):
    """Two-layer visual fields on `device` (the card when None).

    points:      (N, 2) float32 -- tesselated outline points, all fish
    point_ids:   (N,)  int32    -- owning positional fish id per point
    point_valid: (N,)  bool     -- padding mask
    eye_pos:     (F, 2, 2) float32
    eye_angle:   (F, 2) float32 -- eye view directions (radians)
    max_d:       float -- arena diagonal for the depth scale and fov

    Returns a dict of (F, 2, n_bins) tensors on `device`: depth0/1
    (float32), id0/1 (int32), fov0/1 (uint8)."""
    dev = resolve_device(device)

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    return _visual_field(t(points, _F32), t(point_ids, _I32),
                         t(np.asarray(point_valid).astype(np.int32), _I32),
                         t(eye_pos, _F32), t(eye_angle, _F32),
                         float(max_d), n_bins)


def _visual_field(points: torch.Tensor, point_ids: torch.Tensor,
                  point_valid: torch.Tensor, eye_pos: torch.Tensor,
                  eye_angle: torch.Tensor, max_d: float,
                  n_bins: int = FIELD_RESOLUTION) -> dict:
    F = eye_pos.shape[0]
    N = points.shape[0]
    E = F * 2
    dev = points.device

    epos = eye_pos.reshape(E, 2)
    eang = eye_angle.reshape(E)
    eye_fish = torch.arange(F, dtype=_I32, device=dev).repeat_interleave(2)

    # (E, N) planes
    dx = points[None, :, 0] - epos[:, 0, None]
    dy = points[None, :, 1] - epos[:, 1, None]
    dist = _hypot(dx, dy)
    ang = _atan2(dy, dx) - eang[:, None]
    del dx, dy
    ang = _mod(ang + _c(math.pi, ang), _c(2 * math.pi, ang)) \
        - _c(math.pi, ang)
    fov = _c(SYMMETRIC_FOV, ang)
    in_fov = (ang.abs() <= fov) & (point_valid[None, :] > 0)
    bins = _div_mul(ang + fov, 2 * SYMMETRIC_FOV, n_bins).to(_I32)
    del ang
    bins = bins.clamp(0, n_bins - 1)

    depth_levels = (1 << _DEPTH_BITS) - 1
    dq = _div_mul(dist, max_d, depth_levels).clamp(0, depth_levels) \
        .to(_I32)
    del dist
    ids = point_ids[None, :].expand(E, N)
    key = (dq << _ID_BITS) | ids
    del dq
    eye_base = torch.arange(E, dtype=torch.int64, device=dev)[:, None] \
        * n_bins
    big = 2 ** 30

    def layer(invalid):
        """Min (depth, id) key per (eye, bin) as one flat scatter-min;
        invalid pairs carry the `big` sentinel and lose every min."""
        kval = torch.where(invalid, big, key).reshape(-1)
        seg = (eye_base + torch.where(invalid, 0, bins)).reshape(-1)
        found = torch.full((E * n_bins,), big, dtype=_I32, device=dev)
        found.scatter_reduce_(0, seg, kval, "amin")
        found = found.reshape(E, n_bins)
        hit = found < big
        fdq = found >> _ID_BITS
        fid = found & ((1 << _ID_BITS) - 1)
        depth = _div_mul(fdq.to(_F32), depth_levels, max_d)
        depth = torch.where(hit, depth, _c(INVALID, depth))
        fish = torch.where(hit, fid, -1)
        return depth, fish

    d0, i0 = layer(~in_fov)
    # layer 1: exclude the points of the layer-0 winner at each point's
    # bin and of the eye's own fish (VisualField.cpp layer semantics)
    id_at_bin = torch.gather(i0, 1, bins.to(torch.int64))
    excluded = (ids == id_at_bin) | (ids == eye_fish[:, None])
    d1, i1 = layer(~in_fov | excluded)

    def fov_value(dd):
        # VisualField.cpp: fov = (1 - d/max_d)^2 * 255 with d the squared
        # distance and max_d = cols^2 + rows^2, i.e. (1 - (dist/diag)^2)^2
        q = _div_mul(dd, max_d)
        r2 = (q * q).clamp(0.0, 1.0)
        u = 1.0 - r2
        v = u * u * _c(255.0, u)
        return torch.where(dd >= _c(INVALID, dd), 0.0, v).to(torch.uint8)

    shape = (F, 2, n_bins)
    # keys in sorted order, as jax.jit returns the JAX package's dict (the
    # export writes its npz members in this order)
    return {
        "depth0": d0.reshape(shape), "depth1": d1.reshape(shape),
        "fov0": fov_value(d0).reshape(shape),
        "fov1": fov_value(d1).reshape(shape),
        "id0": i0.reshape(shape), "id1": i1.reshape(shape),
    }
