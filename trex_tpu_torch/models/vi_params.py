"""The JAX package's weight files carried across to the port's networks.

``trex_tpu/models/training.py`` saves a network as one flat npz:
``params/<path>/kernel|bias|scale|<raw name>`` and
``batch_stats/<path>/mean|var``, plus ``__meta__`` (num_classes and
image_shape as JSON). The port's modules carry flax's names
(``layers.py``), so a path maps to a module by name; the arrays change
layout by layer:

- ``Conv``: kernel HWIO <-> weight OIHW;
- ``Dense``: kernel (in, out) <-> weight (out, in); the first dense after
  a flatten sees (H, W, C)-ordered features in flax and (C, H, W)-ordered
  ones here, so its input axis is reordered;
- ``BatchNorm``: scale, bias; mean and var in ``batch_stats``;
- ``LayerNorm``, the attention projections and raw parameters
  (``pos_embed``, ``layer_scale``): as they are.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from .layers import BatchNorm, Conv, Dense, DenseGeneral, LayerNorm


def _dense_kernel(w: np.ndarray, chw) -> np.ndarray:
    """torch weight (out, in) -> flax kernel (in, out)."""
    if chw is not None:
        c, h, ww = chw
        w = w.reshape(-1, c, h, ww).transpose(0, 2, 3, 1).reshape(
            w.shape[0], -1)
    return w.T


def _dense_weight(k: np.ndarray, chw) -> np.ndarray:
    """flax kernel (in, out) -> torch weight (out, in)."""
    w = k.T
    if chw is not None:
        c, h, ww = chw
        w = w.reshape(-1, h, ww, c).transpose(0, 3, 1, 2).reshape(
            w.shape[0], -1)
    return w


def _entries(model: nn.Module):
    """(flat key, tensor, to_flax, from_flax) for every array of
    `model`, in the flax layout's terms."""
    ident = (lambda a: a, lambda a: a)
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        pre = f"params/{path}/" if path else "params/"
        if isinstance(mod, Conv):
            yield (pre + "kernel", mod.weight,
                   lambda a: a.transpose(2, 3, 1, 0),
                   lambda a: a.transpose(3, 2, 0, 1))
            if mod.bias is not None:
                yield (pre + "bias", mod.bias, *ident)
        elif isinstance(mod, Dense):
            chw = mod.chw
            yield (pre + "kernel", mod.weight,
                   lambda a, chw=chw: _dense_kernel(a, chw),
                   lambda a, chw=chw: _dense_weight(a, chw))
            yield (pre + "bias", mod.bias, *ident)
        elif isinstance(mod, (BatchNorm, LayerNorm)):
            yield (pre + "scale", mod.scale, *ident)
            yield (pre + "bias", mod.bias, *ident)
            if isinstance(mod, BatchNorm):
                stats = f"batch_stats/{path}/"
                yield (stats + "mean", mod.mean, *ident)
                yield (stats + "var", mod.var, *ident)
        elif isinstance(mod, DenseGeneral):
            yield (pre + "kernel", mod.kernel, *ident)
            yield (pre + "bias", mod.bias, *ident)
        else:
            for pname in getattr(mod, "_inits", {}):
                yield (pre + pname, mod._parameters[pname], *ident)


def to_flax_arrays(model: nn.Module) -> dict:
    """The flat flax-layout arrays (float32 numpy) of a made `model`,
    in the order the JAX package's ``save_weights`` writes them (flax's
    ``tree_flatten_with_path``: sorted at every level)."""
    out = {}
    for key, t, to_flax, _ in _entries(model):
        out[key] = np.ascontiguousarray(
            to_flax(t.detach().to("cpu", torch.float32).numpy()))
    return {k: out[k] for k in sorted(out, key=lambda k: k.split("/"))}


@torch.no_grad()
def from_flax_arrays(model: nn.Module, arrays) -> nn.Module:
    """Load flat flax-layout arrays (a mapping such as an open npz) into
    a made `model`, in place. Every array the model has must be there
    with its shape; other keys (``__meta__``) are ignored."""
    for key, t, _, from_flax in _entries(model):
        if key not in arrays:
            raise KeyError(f"missing weight {key}")
        a = from_flax(np.array(arrays[key], np.float32))
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"weight {key}: shape {tuple(a.shape)} does "
                             f"not fit the network's {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return model
