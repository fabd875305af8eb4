"""Ultralytics ``.pt`` checkpoint -> the port's YOLOv8 state.

The port of ``trex_tpu/models/yolo_convert.py``. The checkpoint's
state_dict maps onto the module tree of ``models/yolo.py`` by name; its
tensors are torch's own layout already (OIHW, the transposed
convolution's (in, out, kh, kw)), so nothing is transposed. Loading uses
a tolerant unpickler, so that the ``ultralytics`` package is not needed:
classes that cannot be imported become stubs that keep their attribute
dicts, and only the tensors are read.
"""
from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .yolo import SCALES


class _Stub:
    """Placeholder for unpicklable classes; keeps attribute dict."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ModuleNotFoundError, AttributeError):
            return type(name, (_Stub,), {"__module__": module})


class _TolerantPickle:
    Unpickler = _TolerantUnpickler

    @staticmethod
    def load(*a, **k):
        return _TolerantUnpickler(*a, **k).load()


def _tolerant_torch_load(path):
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except (ModuleNotFoundError, AttributeError):
        pass
    with open(path, "rb") as f:
        return torch.load(f, map_location="cpu", weights_only=False,
                          pickle_module=_TolerantPickle)


def extract_state_dict(ckpt: Any) -> dict[str, np.ndarray]:
    """The flat name -> float32 array map of an ultralytics checkpoint."""
    model = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    sd = None
    if hasattr(model, "state_dict"):
        try:
            sd = model.state_dict()
        except Exception:
            sd = None
    if sd is None:
        # stub object: walk the _modules/_parameters/_buffers dicts
        sd = {}

        def walk(obj, prefix=""):
            d = getattr(obj, "__dict__", {})
            for name, t in d.get("_parameters", {}).items():
                if t is not None:
                    sd[prefix + name] = t
            for name, t in d.get("_buffers", {}).items():
                if t is not None:
                    sd[prefix + name] = t
            for name, child in d.get("_modules", {}).items():
                if child is not None:
                    walk(child, prefix + name + ".")

        walk(model)
    return {k: v.detach().float().numpy() if hasattr(v, "detach")
            else np.asarray(v) for k, v in sd.items()}


def _convbn(sd, src, dst, out):
    """ultralytics Conv (conv + bn) -> ConvBNSiLU ``dst``."""
    out[f"{dst}.conv.weight"] = sd[f"{src}.conv.weight"]
    for a, b in (("weight", "scale"), ("bias", "bias"),
                 ("running_mean", "mean"), ("running_var", "var")):
        out[f"{dst}.bn.{b}"] = sd[f"{src}.bn.{a}"]


def _c2f(sd, src, dst, n, out):
    _convbn(sd, f"{src}.cv1", f"{dst}.cv1", out)
    _convbn(sd, f"{src}.cv2", f"{dst}.cv2", out)
    for i in range(n):
        for cv in ("cv1", "cv2"):
            _convbn(sd, f"{src}.m.{i}.{cv}", f"{dst}.m{i}.{cv}", out)


def _branch(sd, src, dst, out):
    """Detect/Segment/Pose/OBB's per-level Sequential -> ``{dst}{i}_j``."""
    for i in range(3):
        for j in range(2):
            _convbn(sd, f"{src}.{i}.{j}", f"{dst}{i}_{j}", out)
        out[f"{dst}{i}_2.weight"] = sd[f"{src}.{i}.2.weight"]
        out[f"{dst}{i}_2.bias"] = sd[f"{src}.{i}.2.bias"]


def convert_state_dict(sd: dict[str, np.ndarray], scale: str,
                       task: str = "detect") -> dict:
    """Map ultralytics layer indices onto the port's module tree.

    ultralytics yolov8 layer order (model.N.):
      0 stem, 1 down1, 2 c2f1, 3 down2, 4 c2f2, 5 down3, 6 c2f3,
      7 down4, 8 c2f4, 9 sppf, 12 up_c2f1, 15 up_c2f2, 16 down_conv1,
      18 down_c2f1, 19 down_conv2, 21 down_c2f2, 22 head
    """
    depth, _, _ = SCALES[scale]

    def nd(n):
        return max(1, round(n * depth))

    out: dict = {}
    m = "model."
    for idx, name in ((0, "stem"), (1, "down1"), (3, "down2"),
                      (5, "down3"), (7, "down4")):
        _convbn(sd, f"{m}{idx}", f"backbone.{name}", out)
    for idx, name, n in ((2, "c2f1", 3), (4, "c2f2", 6), (6, "c2f3", 6),
                         (8, "c2f4", 3)):
        _c2f(sd, f"{m}{idx}", f"backbone.{name}", nd(n), out)
    for cv in ("cv1", "cv2"):
        _convbn(sd, f"{m}9.{cv}", f"backbone.sppf.{cv}", out)
    for idx, name in ((12, "up_c2f1"), (15, "up_c2f2"), (18, "down_c2f1"),
                      (21, "down_c2f2")):
        _c2f(sd, f"{m}{idx}", f"neck.{name}", nd(3), out)
    _convbn(sd, f"{m}16", "neck.down_conv1", out)
    _convbn(sd, f"{m}19", "neck.down_conv2", out)
    _branch(sd, f"{m}22.cv2", "detect.box", out)
    _branch(sd, f"{m}22.cv3", "detect.cls", out)
    head = {"segment": "mask", "pose": "kpt", "obb": "ang"}
    if task in head and f"{m}22.cv4.0.0.conv.weight" in sd:
        _branch(sd, f"{m}22.cv4", head[task], out)
    if task == "segment" and f"{m}22.proto.cv1.conv.weight" in sd:
        for cv in ("cv1", "cv2", "cv3"):
            _convbn(sd, f"{m}22.proto.{cv}", f"proto_{cv}", out)
        # torch's ConvTranspose2d taps are the port's: no flip
        out["proto_up.weight"] = sd[f"{m}22.proto.upsample.weight"]
        out["proto_up.bias"] = sd[f"{m}22.proto.upsample.bias"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


SCALE_BY_WIDTH = {0.25: "n", 0.5: "s", 0.75: "m", 1.0: "l", 1.25: "x"}


def load_ultralytics_checkpoint(path, device=None) -> dict:
    """Load + convert; returns dict(state, num_classes, task, scale, and
    for pose num_keypoints and kpt_dims), the state's float32 tensors on
    `device` (the card unless the CPU is named)."""
    dev = resolve_device(device)
    path = Path(str(path))
    sd = extract_state_dict(_tolerant_torch_load(path))
    # num_classes from the cls head bias, scale from the stem's width
    ncls_key = "model.22.cv3.0.2.bias"
    num_classes = int(sd[ncls_key].shape[0]) if ncls_key in sd else 80
    stem = sd.get("model.0.conv.weight")
    width = stem.shape[0] / 64 if stem is not None else 0.25
    scale = SCALE_BY_WIDTH[min(SCALE_BY_WIDTH, key=lambda w: abs(w - width))]
    task = "detect"
    kpt_out = None
    if any(k.startswith("model.22.cv4") for k in sd):
        if "model.22.proto.cv1.conv.weight" in sd:
            task = "segment"
        else:
            kpt_out = int(sd["model.22.cv4.0.2.bias"].shape[0])
            task = "obb" if kpt_out == 1 else "pose"
    state = {k: torch.from_numpy(v).to(dev)
             for k, v in convert_state_dict(sd, scale, task).items()}
    out = {"state": state,
           "num_classes": num_classes, "task": task, "scale": scale}
    if task == "pose" and kpt_out is not None:
        out["kpt_dims"] = 3 if kpt_out % 3 == 0 else 2
        out["num_keypoints"] = kpt_out // out["kpt_dims"]
    return out
