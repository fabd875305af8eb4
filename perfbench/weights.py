"""Seeded YOLOv8 weights, calibrated on the cell's own frames, written as
an ultralytics checkpoint.

The weights are drawn on the device from one ``torch.Generator`` in a
few large calls: convolutions LeCun-normal (the class head's last layer
``CLS_GAIN`` times that, the keypoint head's ``KPT_GAIN`` times, so that
keypoints lie near their anchors as a trained model's lie near its
boxes, and the box head's ``BOX_GAIN`` times), the head's last biases
small but the keypoint head's, which place the keypoints on a fixed
body template around the anchor. BatchNorm scales are ``BN_SCALE`` (1 + 0.1 z) and shifts
``BN_SCALE`` 0.1 z: with scales near 1 the random network is chaotic
(each layer's normalisation and SiLU grow a rounding by a factor above
1, over some sixty layers in a row), so that a bfloat16 forward and a
float8 one both decorrelate from float32 and no limit separates them;
at 0.1 each SiLU works near its linear part, a rounding grows about
additively, and a bfloat16 forward keeps to float32 within about a
hundredth of the scores' spread while float8 departs some twenty times
further (``PERF.md``). A trained network is not chaotic either. The
class head's last biases are
ultralytics' ``Detect.bias_init`` prior. The box head's last biases
peak each side's distribution (DFL, 16 bins) at the animals' half
length in the level's stride, so that the boxes come out about as large
as the animals, as a trained model's do: with even biases (ultralytics'
initial 1.0) every side is 7.5 strides long, up to 480 pixels, and the
host would rasterise boxes no animal has.

A random network's features hardly vary over a scene of small animals
unless its BatchNorm statistics come from the scene, as a trained
model's come from its data. So the reference forward
(:mod:`perfbench.reference.yolov8`, float32) runs once over the tiles
of the first frames of the pool with every BatchNorm set to its input's
batch statistics, and the class head's last biases are then shifted by
one amount so that the class scores pass the threshold on as many
anchors as the tiles show animals (the animals' share of the tiles'
area). The detections a frame, and so the host's work after the
forward, are then about the same for every seed.

The checkpoint is saved in half precision, as ultralytics saves its
checkpoints, and the reference later runs on exactly those values.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from .reference import postprocess, yolov8

CLS_GAIN = 4.0
KPT_GAIN = 0.1
BOX_GAIN = 0.1
BN_SCALE = 0.1


def _fill(tensors, generator, scales):
    """One normal draw for all `tensors`, each scaled by its `scales`."""
    total = sum(t.numel() for t in tensors)
    dev = tensors[0].device
    z = torch.randn(total, generator=generator, device=dev)
    z = z.clamp_(-2, 2).div_(0.87962566103423978)
    i = 0
    for t, s in zip(tensors, scales):
        t.copy_(z[i:i + t.numel()].view_as(t) * s)
        i += t.numel()


def random_model(config: dict, generator: torch.Generator, device,
                 half_length_px: float) -> yolov8.YOLOv8:
    """The seeded network before calibration; `half_length_px` is the
    animals' half length in pixels."""
    model = yolov8.YOLOv8(config["scale"], config["task"], config["nc"],
                          config.get("kpt_shape", (17, 3))).to(device)
    head = model.model[22]
    half_length = float(half_length_px)
    gain = {id(seq[2]): CLS_GAIN for seq in head.cv3}
    gain.update({id(seq[2]): BOX_GAIN for seq in head.cv2})
    if hasattr(head, "cv4") and config["task"] == "pose":
        gain.update({id(seq[2]): KPT_GAIN for seq in head.cv4})
    convs = [m for m in model.modules() if isinstance(m, nn.Conv2d)
             and m is not head.dfl.conv]
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        _fill([m.weight for m in convs], generator,
              [gain.get(id(m), 1.0) / math.sqrt(m.weight[0].numel())
               for m in convs])
        biases = [m.bias for m in convs if m.bias is not None]
        _fill(biases, generator, [0.01] * len(biases))
        _fill([m.weight for m in bns] + [m.bias for m in bns], generator,
              [0.1 * BN_SCALE] * (2 * len(bns)))
        for m in bns:
            m.weight.add_(BN_SCALE)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        if config["task"] == "pose":
            # keypoints at a fixed body template around each anchor (a
            # trained model's lie over the animal): offsets drawn once,
            # up to the half length along x and half that along y
            k, d = model.kpt_shape
            span = torch.tensor([half_length, half_length / 2],
                                device=device)
            offs = (torch.rand(k, 2, generator=generator, device=device)
                    * 2 - 1) * span
            for seq, s in zip(head.cv4, yolov8.STRIDES):
                b = seq[2].bias.view(k, d)
                b[:, :2] = 0.25 + offs / (2 * s)
        bins = torch.arange(yolov8.REG_MAX, dtype=torch.float32,
                            device=device)
        for box, cls, s in zip(head.cv2, head.cv3, yolov8.STRIDES):
            peak = min(half_length_px / s, yolov8.REG_MAX - 1)
            box[2].bias.copy_((-0.5 * (bins - peak) ** 2).repeat(4))
            cls[2].bias.fill_(math.log(5 / config["nc"] / (640 / s) ** 2))
    return model.eval()


def tiles_of(frames, config, settings):
    size = int(config["imgsz"])
    out = []
    for f in frames:
        h, w = f.shape[:2]
        for x, y, tw, th in postprocess.tile_bounds(
                w, h, size, int(settings.get("detect_tile_target_width", 0)),
                int(settings.get("detect_tile_image", 0)),
                float(settings.get("detect_tile_overlap", 0.0))):
            out.append(postprocess.letterbox(f[y:y + th, x:x + tw], size))
    return np.stack(out)


def calibrated(config: dict, traffic: dict, settings: dict,
               frames: list, seed: int, device, stat_frames: int = 1,
               block: int = 32) -> yolov8.YOLOv8:
    """The seeded model in half precision (its values as the checkpoint
    holds them): BatchNorm statistics from the tiles of the first
    `stat_frames` frames, then the class head's biases shifted so that
    over the tiles of all `frames` as many anchors pass the threshold as
    the tiles' area holds animals at the scene's density."""
    gen = torch.Generator(device=device).manual_seed(seed)
    half_length = traffic.get("stamp_scale", 1) * 15 / 2
    model = random_model(config, gen, device, half_length).half().float()
    with torch.no_grad(), yolov8.no_tf32():
        tiles = torch.from_numpy(tiles_of(frames[:stat_frames], config,
                                          settings)).to(device)
        yolov8.set_mode(model, calibrate=True)
        model(tiles.permute(0, 3, 1, 2))
        yolov8.set_mode(model, calibrate=False)
        del tiles
        model.half().float()  # the statistics as the checkpoint holds them
        # the count over the pool in TF32: its rounding is an eighth of
        # the bfloat16 forward's, and it is some four times faster than
        # float32 here, where it is most of the set-up
        torch.backends.cudnn.allow_tf32 = True
        logits, n_tiles = [], 0
        for f in frames:
            tiles = tiles_of([f], config, settings)
            n_tiles += len(tiles)
            for i in range(0, len(tiles), block):
                x = torch.from_numpy(tiles[i:i + block]).to(device)
                cls = model(x.permute(0, 3, 1, 2))["cls"]
                logits.append(torch.cat([c.flatten(2) for c in cls],
                                        2).amax(1).flatten())
        logit = torch.cat(logits)
    size = int(config["imgsz"])
    frame_area = frames[0].shape[0] * frames[0].shape[1]
    per_tile = traffic["animals"] * size * size / frame_area
    target = max(1, round(per_tile * n_tiles))
    kth = float(logit.topk(target).values[-1])
    thr = float(settings.get("detect_conf_threshold") or 0.1)
    shift = math.log(thr / (1 - thr)) - kth
    with torch.no_grad():
        for cls in model.model[22].cv3:
            cls[2].bias.add_(shift)
    return model.half()


def write_checkpoint(model: yolov8.YOLOv8, path) -> None:
    """``{"model": model}`` as ultralytics pickles it (half precision)."""
    torch.save({"model": model, "epoch": -1, "date": None}, path)
