"""Operations and bytes of a YOLOv8 forward, counted from layer shapes.

The reference model (:mod:`perfbench.reference.yolov8`) runs once on the
``meta`` device, where no arithmetic happens, and a hook on each
convolution reads its input and output shapes. A convolution of ``c_in``
to ``c_out`` channels with a ``k x k`` kernel onto ``h x w`` outputs
counts ``2 c_in c_out k^2 h w`` operations (a multiply and an add), as
ultralytics' GFLOPs column counts them. Its bytes are its input read
once, its weight read once and its output written once, each element of
``elem_bytes`` (the type the configuration serves the convolutions in):
the least traffic a forward needs, with each BatchNorm and SiLU fused
into its convolution. The decode and the head's small output
convolutions are included; pooling, upsampling and concatenation move
no bytes that a fused forward would not already count.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .reference import yolov8


def forward_cost(config: dict, batch: int = 1, elem_bytes: int = 2) -> dict:
    """``{"flops": ..., "bytes": ..., "params": ...}`` of a forward of
    `batch` images of the configuration's input size."""
    with torch.device("meta"):
        model = yolov8.YOLOv8(config["scale"], config["task"], config["nc"],
                              config.get("kpt_shape", (17, 3)))
    total = {"flops": 0, "bytes": 0}

    def count(conv: nn.Conv2d, x_shape, y_shape):
        cout, cin_g, kh, kw = conv.weight.shape
        n, _, h, w = y_shape
        total["flops"] += 2 * n * cout * cin_g * kh * kw * h * w
        total["bytes"] += elem_bytes * (
            x_shape.numel() + conv.weight.numel() + y_shape.numel())

    hooks = []
    for m in model.modules():
        if isinstance(m, yolov8.Conv):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out: count(mod.conv, inp[0].shape,
                                            out.shape)))
        elif isinstance(m, nn.Sequential):
            last = m[-1]
            hooks.append(last.register_forward_hook(
                lambda mod, inp, out: count(mod, inp[0].shape, out.shape)))
    size = int(config["imgsz"])
    with torch.no_grad():
        model(torch.empty(batch, 3, size, size, device="meta"))
    for h in hooks:
        h.remove()
    params = sum(p.numel() for p in model.parameters()) \
        - model.model[22].dfl.conv.weight.numel()
    return {**total, "params": params}
