"""Reference `.pt` VI weight import (counterpart of
``trex_tpu/models/vi_convert.py``): torch state_dicts from the
reference's visual_identification_network_torch.py models into the
JAX package's flat flax layout, which ``vi_params.from_flax_arrays``
loads into the port's networks (models/vi_network.py).

The reference trains with torch and saves `<filename>_weights.pt`
(visual_recognition_torch.py save_model_files); importing them lets a
reference-trained identity network run unchanged on the card.

Layout notes:
- torch conv OIHW -> flax HWIO
- the first Linear after flatten sees (C, H, W)-ordered features in
  torch but (H, W, C)-ordered in flax; its weight reorders accordingly
- BatchNorm2d weight/bias -> bn scale/bias, running stats -> batch_stats
- LayerNorm weight/bias -> scale/bias
"""
from __future__ import annotations

from typing import Any

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _conv(sd, key):
    return np.transpose(_np(sd[key + ".weight"]), (2, 3, 1, 0)), \
        _np(sd[key + ".bias"])


def _bn2d(sd, key):
    return ({"scale": _np(sd[key + ".weight"]),
             "bias": _np(sd[key + ".bias"])},
            {"mean": _np(sd[key + ".running_mean"]),
             "var": _np(sd[key + ".running_var"])})


def _linear(sd, key, nchw_in: tuple = None):
    """torch Linear weight (out, in) -> flax kernel (in, out); when the
    input came from flattening an NCHW feature map, reorder the input
    dim from (C, H, W) to flax's (H, W, C)."""
    w = _np(sd[key + ".weight"])
    b = _np(sd[key + ".bias"])
    if nchw_in is not None:
        c, h, ww = nchw_in
        w = w.reshape(-1, c, h, ww).transpose(0, 2, 3, 1).reshape(
            w.shape[0], -1)
    return {"kernel": w.T, "bias": b}


def _strip(sd: dict) -> dict:
    """Drop wrapper prefixes (PermuteAxesWrapper.model., module., a
    leading 'model.')."""
    for pre in ("model.", "module.", "net."):
        if all(k.startswith(pre) for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items()}
    return sd


def convert_v118_3(sd: dict, image_size=(80, 80)) -> dict:
    """Reference V118_3 (visual_identification_network_torch.py:184-214:
    conv1..3 5x5 + bn + pool2, fc1->100, LayerNorm, fc2)."""
    sd = _strip(sd)
    h, w = image_size
    fh, fw = h // 8, w // 8
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    for i in range(3):
        k, b = _conv(sd, f"conv{i + 1}")
        bnp, bns = _bn2d(sd, f"bn{i + 1}")
        params[f"ConvBlock_{i}"] = {
            "Conv_0": {"kernel": k, "bias": b}, "BatchNorm_0": bnp}
        stats[f"ConvBlock_{i}"] = {"BatchNorm_0": bns}
    params["Dense_0"] = _linear(sd, "fc1", nchw_in=(128, fh, fw))
    params["LayerNorm_0"] = {"scale": _np(sd["bn4.weight"]),
                             "bias": _np(sd["bn4.bias"])}
    params["Dense_1"] = _linear(sd, "fc2")
    return {"params": params, "batch_stats": stats}


def convert_v119(sd: dict, image_size=(80, 80)) -> dict:
    """Reference V119 (conv1..4 5x5, fc1->1024 + BatchNorm1d, fc2)."""
    sd = _strip(sd)
    h, w = image_size
    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    feats = [256, 128, 32, 128]
    for i in range(4):
        k, b = _conv(sd, f"conv{i + 1}")
        bnp, bns = _bn2d(sd, f"bn{i + 1}")
        params[f"ConvBlock_{i}"] = {
            "Conv_0": {"kernel": k, "bias": b}, "BatchNorm_0": bnp}
        stats[f"ConvBlock_{i}"] = {"BatchNorm_0": bns}
    fh, fw = h // 16, w // 16
    params["Dense_0"] = _linear(sd, "fc1", nchw_in=(feats[-1], fh, fw))
    bnp, bns = _bn2d(sd, "bn5")
    params["BatchNorm_0"] = bnp
    stats["BatchNorm_0"] = bns
    params["Dense_1"] = _linear(sd, "fc2")
    return {"params": params, "batch_stats": stats}


_CONVERTERS = {
    "v118_3": convert_v118_3,
    "v118": convert_v118_3,
    "v119": convert_v119,
}


def flatten_variables(variables: dict) -> dict:
    """{"params": {...}, "batch_stats": {...}} -> the flat
    ``params/...``/``batch_stats/...`` keys of a weights npz."""
    out = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}/", v)
            else:
                out[f"{prefix}{k}"] = np.asarray(v)
    walk("", variables)
    return out


def load_torch_vi_weights(path, version: str = "v118_3",
                          image_size=(80, 80)) -> dict:
    """Load a reference `<file>_weights.pt` checkpoint and convert to
    flax variables for models/vi_network.build(version); pass them
    through :func:`flatten_variables` to ``vi_params.from_flax_arrays``."""
    import torch

    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        sd = obj["state_dict"]
    elif isinstance(obj, dict) and all(
            hasattr(v, "shape") or hasattr(v, "detach")
            for v in obj.values()):
        sd = obj
    elif hasattr(obj, "state_dict"):
        sd = obj.state_dict()
    else:
        raise ValueError(f"unrecognized checkpoint structure: {type(obj)}")
    conv = _CONVERTERS.get(version.lower())
    if conv is None:
        raise ValueError(
            f"no torch VI importer for version {version!r} "
            f"(supported: {sorted(_CONVERTERS)})")
    return conv(sd, image_size)
