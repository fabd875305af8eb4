"""YOLOv8-family detection models in torch (NCHW).

The port of ``trex_tpu/models/yolo.py``: the same architecture and the
same module names, so that the JAX package's flax variables carry across
by path (:func:`state_from_flax`) and ultralytics ``.pt`` checkpoints
convert 1:1 (``yolo_convert.py``):

  backbone: Conv stem -> C2f stages -> SPPF
  neck:     PAN-FPN over P3/P4/P5
  heads:    Detect (DFL reg_max=16 + cls), Segment (+32 proto masks),
            Pose (keypoints), OBB (+angle)

Precision is the JAX package's: the 3x3 and 1x1 ConvBNSiLU convolutions
compute in ``dtype`` (bfloat16 by default), BatchNorm and SiLU in
float32, and the head's 1x1 output convolutions and the proto
``ConvTranspose`` (``proto_up``) in float32. ``dtype=torch.float32``
runs everything in float32.

:func:`decode_predictions` runs on the model's device: DFL expectation,
``dist2bbox`` over per-level anchors, sigmoid scores, keypoints and the
OBB's rotated decode, as ultralytics' inference path computes them.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv

SCALES = {
    # depth, width, max_channels: ultralytics yolov8 scales
    "n": (1 / 3, 0.25, 1024),
    "s": (1 / 3, 0.50, 1024),
    "m": (2 / 3, 0.75, 768),
    "l": (1.0, 1.00, 512),
    "x": (1.0, 1.25, 512),
}

BN_EPS = 1e-3  # flax BatchNorm(epsilon=1e-3) of the JAX package


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(round(x / divisor) * divisor))


class ConvBNSiLU(nn.Module):
    def __init__(self, c_in: int, features: int, kernel: int = 1,
                 stride: int = 1, dtype=torch.bfloat16):
        super().__init__()
        pad = kernel // 2
        self.conv = Conv(c_in, features, kernel, stride,
                         ((pad, pad), (pad, pad)), use_bias=False,
                         dtype=dtype)
        self.bn = BatchNorm(features, epsilon=BN_EPS, momentum=0.97)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, features: int, shortcut: bool = True,
                 dtype=torch.bfloat16):
        super().__init__()
        self.cv1 = ConvBNSiLU(c_in, features, 3, dtype=dtype)
        self.cv2 = ConvBNSiLU(features, features, 3, dtype=dtype)
        self.add = shortcut and c_in == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c_in: int, features: int, n: int = 1,
                 shortcut: bool = False, dtype=torch.bfloat16):
        super().__init__()
        c = features // 2
        self.c = c
        self.n = n
        self.cv1 = ConvBNSiLU(c_in, 2 * c, 1, dtype=dtype)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c, c, shortcut, dtype))
        self.cv2 = ConvBNSiLU((2 + n) * c, features, 1, dtype=dtype)

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    def __init__(self, c_in: int, features: int, dtype=torch.bfloat16):
        super().__init__()
        c = features // 2
        self.cv1 = ConvBNSiLU(c_in, c, 1, dtype=dtype)
        self.cv2 = ConvBNSiLU(4 * c, features, 1, dtype=dtype)

    def forward(self, x):
        x = self.cv1(x)
        pools = [x]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, 1))


class _Scaled(nn.Module):
    def __init__(self, depth: float, width: float, max_channels: int):
        super().__init__()
        self.depth, self.width, self.max_channels = depth, width, \
            max_channels

    def ch(self, c):
        return _make_divisible(min(c, self.max_channels) * self.width)

    def nd(self, n):
        return max(1, round(n * self.depth))


class Backbone(_Scaled):
    def __init__(self, depth, width, max_channels, dtype=torch.bfloat16):
        super().__init__(depth, width, max_channels)
        ch, nd, d = self.ch, self.nd, dtype
        self.stem = ConvBNSiLU(3, ch(64), 3, 2, d)
        self.down1 = ConvBNSiLU(ch(64), ch(128), 3, 2, d)
        self.c2f1 = C2f(ch(128), ch(128), nd(3), True, d)
        self.down2 = ConvBNSiLU(ch(128), ch(256), 3, 2, d)
        self.c2f2 = C2f(ch(256), ch(256), nd(6), True, d)
        self.down3 = ConvBNSiLU(ch(256), ch(512), 3, 2, d)
        self.c2f3 = C2f(ch(512), ch(512), nd(6), True, d)
        self.down4 = ConvBNSiLU(ch(512), ch(1024), 3, 2, d)
        self.c2f4 = C2f(ch(1024), ch(1024), nd(3), True, d)
        self.sppf = SPPF(ch(1024), ch(1024), d)

    def forward(self, x):
        x = self.c2f1(self.down1(self.stem(x)))
        p3 = self.c2f2(self.down2(x))
        p4 = self.c2f3(self.down3(p3))
        p5 = self.sppf(self.c2f4(self.down4(p4)))
        return p3, p4, p5


class PANNeck(_Scaled):
    def __init__(self, depth, width, max_channels, dtype=torch.bfloat16):
        super().__init__(depth, width, max_channels)
        ch, nd, d = self.ch, self.nd, dtype
        self.up_c2f1 = C2f(ch(1024) + ch(512), ch(512), nd(3), False, d)
        self.up_c2f2 = C2f(ch(512) + ch(256), ch(256), nd(3), False, d)
        self.down_conv1 = ConvBNSiLU(ch(256), ch(256), 3, 2, d)
        self.down_c2f1 = C2f(ch(256) + ch(512), ch(512), nd(3), False, d)
        self.down_conv2 = ConvBNSiLU(ch(512), ch(512), 3, 2, d)
        self.down_c2f2 = C2f(ch(512) + ch(1024), ch(1024), nd(3), False,
                             d)

    def forward(self, feats):
        p3, p4, p5 = feats

        def up(x):
            return F.interpolate(x, scale_factor=2, mode="nearest")

        n4 = self.up_c2f1(torch.cat([up(p5), p4], 1))
        n3 = self.up_c2f2(torch.cat([up(n4), p3], 1))
        n4b = self.down_c2f1(torch.cat([self.down_conv1(n3), n4], 1))
        n5 = self.down_c2f2(torch.cat([self.down_conv2(n4b), p5], 1))
        return n3, n4b, n5


def _branch(module: nn.Module, prefix: str, chs, c_mid: int, n_out: int,
            dtype):
    """ultralytics' per-level Sequential(Conv 3x3, Conv 3x3, Conv2d 1x1)
    as children ``{prefix}{i}_0/_1/_2`` of `module`; the 1x1 output conv
    computes in float32."""
    for i, c in enumerate(chs):
        module.add_module(f"{prefix}{i}_0", ConvBNSiLU(c, c_mid, 3,
                                                       dtype=dtype))
        module.add_module(f"{prefix}{i}_1", ConvBNSiLU(c_mid, c_mid, 3,
                                                       dtype=dtype))
        module.add_module(f"{prefix}{i}_2", Conv(c_mid, n_out, 1,
                                                 padding="VALID",
                                                 dtype=torch.float32))


def _run_branch(module: nn.Module, prefix: str, feats) -> list:
    out = []
    for i, f in enumerate(feats):
        m = getattr(module, f"{prefix}{i}_0")(f)
        m = getattr(module, f"{prefix}{i}_1")(m)
        out.append(getattr(module, f"{prefix}{i}_2")(m))
    return out


class DetectHead(nn.Module):
    """Per-level box-regression (DFL) + classification branches."""

    def __init__(self, num_classes: int, chs, reg_max: int = 16,
                 dtype=torch.bfloat16):
        super().__init__()
        c2 = max(16, chs[0] // 4, reg_max * 4)
        c3 = max(chs[0], min(num_classes, 100))
        _branch(self, "box", chs, c2, 4 * reg_max, dtype)
        _branch(self, "cls", chs, c3, num_classes, dtype)

    def forward(self, feats):
        return _run_branch(self, "box", feats), \
            _run_branch(self, "cls", feats)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (2, 2), strides=(2, 2))`` in
    float32 as torch's transposed convolution: weight (in, out, kh, kw)
    with the taps in torch's order (flax's kernel mirrored)."""

    def __init__(self, c_in: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_in, features, 2, 2))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        return F.conv_transpose2d(x.float(), self.weight, self.bias,
                                  stride=2)


class YOLOv8(nn.Module):
    """Full model; task in {detect, segment, pose, obb}. Input: (B, 3,
    H, W) pixel values 0-255 (any dtype); output: per-level raw head
    maps, NCHW."""

    def __init__(self, num_classes: int = 80, scale: str = "n",
                 task: str = "detect", reg_max: int = 16,
                 num_keypoints: int = 17, kpt_dims: int = 3,
                 num_masks: int = 32, dtype=torch.bfloat16):
        super().__init__()
        self.num_classes, self.scale, self.task = num_classes, scale, task
        self.reg_max, self.num_keypoints = reg_max, num_keypoints
        self.kpt_dims, self.num_masks, self.dtype = kpt_dims, num_masks, \
            dtype
        depth, width, maxc = SCALES[scale]
        self.backbone = Backbone(depth, width, maxc, dtype)
        self.neck = PANNeck(depth, width, maxc, dtype)
        chs = [self.neck.ch(256), self.neck.ch(512), self.neck.ch(1024)]
        self.detect = DetectHead(num_classes, chs, reg_max, dtype)
        ch0 = chs[0]
        if task == "segment":
            _branch(self, "mask", chs, max(ch0 // 4, num_masks),
                    num_masks, dtype)
            c_ = max(8, int(round(256 * width / 8)) * 8)
            self.proto_cv1 = ConvBNSiLU(ch0, c_, 3, dtype=dtype)
            self.proto_up = ConvTranspose(c_, c_)
            self.proto_cv2 = ConvBNSiLU(c_, c_, 3, dtype=dtype)
            self.proto_cv3 = ConvBNSiLU(c_, num_masks, 1, dtype=dtype)
        elif task == "pose":
            nk = num_keypoints * kpt_dims
            _branch(self, "kpt", chs, max(ch0 // 4, nk), nk, dtype)
        elif task == "obb":
            _branch(self, "ang", chs, max(ch0 // 4, 1), 1, dtype)

    def forward(self, x) -> dict:
        x = x.to(self.dtype) / 255.0
        feats = self.neck(self.backbone(x))
        box_out, cls_out = self.detect(feats)
        out = {"boxes": box_out, "classes": cls_out,
               "shapes": tuple(tuple(f.shape[2:4]) for f in feats)}
        if self.task == "segment":
            out["mask_coeffs"] = _run_branch(self, "mask", feats)
            p = self.proto_cv1(feats[0])
            p = self.proto_up(p)
            out["proto"] = self.proto_cv3(self.proto_cv2(p))
        elif self.task == "pose":
            out["keypoints"] = _run_branch(self, "kpt", feats)
        elif self.task == "obb":
            out["angles"] = _run_branch(self, "ang", feats)
        return out


def init_weights(model: YOLOv8, generator: torch.Generator) -> YOLOv8:
    """Random weights from `generator`: convolutions LeCun-normal as
    flax's default scales it (clipped at two deviations), biases zero,
    BatchNorm identity (scale 1, bias 0, mean 0, var 1). The JAX package
    initialises from ``PRNGKey(0)``; the port draws its own numbers."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (Conv, ConvTranspose)):
                w = m.weight
                fan_in = w.shape[1] * w.shape[2] * w.shape[3] \
                    if isinstance(m, Conv) else w.shape[0] * 4
                std = 1.0 / math.sqrt(fan_in) / 0.87962566103423978
                t = torch.empty(w.shape).normal_(generator=generator)
                w.copy_(torch.clamp(t, -2, 2) * std)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.scale.fill_(1.0)
                m.bias.zero_()
                m.mean.zero_()
                m.var.fill_(1.0)
    return model


def build(num_classes: int = 80, scale: str = "n", task: str = "detect",
          num_keypoints: int = 17, kpt_dims: int = 3, dtype=None,
          state: Optional[dict] = None, device=None,
          generator: Optional[torch.Generator] = None) -> YOLOv8:
    """A YOLOv8 in eval mode on `device` with the port's `state` (as
    :func:`state_from_flax` or ``yolo_convert.convert_state_dict`` give
    it) or, without one, weights drawn from `generator` (seed 0 when
    none is given)."""
    model = YOLOv8(num_classes=num_classes, scale=scale, task=task,
                   num_keypoints=num_keypoints, kpt_dims=kpt_dims,
                   dtype=torch.bfloat16 if dtype is None else dtype)
    if state is None:
        init_weights(model, generator if generator is not None
                     else torch.Generator().manual_seed(0))
    else:
        load_state(model, state)
    # the convolutions' weights kept in their compute type: flax casts
    # them at every call, to the same values
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv) and m.dtype != torch.float32:
                m.weight.data = m.weight.data.to(m.dtype)
    return model.to(device).eval()


def load_state(model: YOLOv8, state: dict) -> YOLOv8:
    """Copy a name -> array map into `model`; every parameter and buffer
    must be named, and nothing else."""
    own = dict(model.state_dict())
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"YOLO state does not fit the model: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for k, t in own.items():
            v = state[k]
            v = v.detach().to(t.device, torch.float32) \
                if isinstance(v, torch.Tensor) \
                else torch.from_numpy(np.array(v, np.float32))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(v)
    return model


# ---------------------------------------------------------------------------
# the JAX package's flax variables carried across
# ---------------------------------------------------------------------------

def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def state_from_flax(params: dict, batch_stats: Optional[dict]) -> dict:
    """The port's state (name -> float32 array) from the JAX package's
    ``params`` and ``batch_stats`` trees of ``trex_tpu/models/yolo.py``'s
    YOLOv8:

    - conv kernels HWIO -> OIHW;
    - BatchNorm ``scale``/``bias`` and ``mean``/``var`` by name (both
      packages use epsilon 1e-3);
    - ``proto_up``: flax's ConvTranspose kernel (kh, kw, in, out) applies
      its taps mirrored against torch's, so it is flipped on kh/kw and
      laid out (in, out, kh, kw)."""
    state = {}
    for key, a in _flat(params).items():
        path, leaf = key.rsplit("/", 1)
        name = path.replace("/", ".")
        a = np.asarray(a, np.float32)
        if path.endswith("proto_up") and leaf == "kernel":
            state[f"{name}.weight"] = np.ascontiguousarray(
                a[::-1, ::-1].transpose(2, 3, 0, 1))
        elif leaf == "kernel":
            state[f"{name}.weight"] = np.ascontiguousarray(
                a.transpose(3, 2, 0, 1))
        else:  # bias, scale
            state[f"{name}.{leaf}"] = a
    for key, a in _flat(batch_stats or {}).items():
        path, leaf = key.rsplit("/", 1)
        state[f"{path.replace('/', '.')}.{leaf}"] = np.asarray(
            a, np.float32)
    return state


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

def make_anchors(shapes: Sequence[tuple], strides=(8, 16, 32),
                 offset: float = 0.5, device=None):
    """Anchor centres (N, 2) + per-anchor stride (N,) for the given
    per-level (h, w) shapes."""
    pts, strs = [], []
    for (h, w), s in zip(shapes, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) + offset
        ys = torch.arange(h, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strs.append(torch.full((h * w,), float(s), dtype=torch.float32,
                               device=device))
    return torch.cat(pts), torch.cat(strs)


def dfl_decode(box_logits: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """Distribution-focal decoding: softmax expectation over reg_max
    bins. (..., 4*reg_max) -> (..., 4) ltrb distances."""
    x = box_logits.reshape(*box_logits.shape[:-1], 4, reg_max)
    p = torch.softmax(x, -1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (p * bins).sum(-1)


def dist2bbox(ltrb: torch.Tensor, anchors: torch.Tensor,
              strides: torch.Tensor) -> torch.Tensor:
    """ltrb distances (anchor units) -> xyxy boxes in input pixels."""
    x0 = (anchors[:, 0] - ltrb[..., 0]) * strides
    y0 = (anchors[:, 1] - ltrb[..., 1]) * strides
    x1 = (anchors[:, 0] + ltrb[..., 2]) * strides
    y1 = (anchors[:, 1] + ltrb[..., 3]) * strides
    return torch.stack([x0, y0, x1, y1], -1)


def _rows(maps: list, B: int) -> torch.Tensor:
    """Per-level (B, C, h, w) maps -> (B, sum h*w, C), rows in the
    anchors' (level, y, x) order."""
    return torch.cat([m.float().permute(0, 2, 3, 1).reshape(
        B, -1, m.shape[1]) for m in maps], 1)


def decode_predictions(out: dict, num_classes: int, reg_max: int = 16,
                       strides=(8, 16, 32)) -> dict:
    """Flatten per-level outputs into (B, N, ...) decoded predictions on
    their device (``proto`` as (B, mh, mw, nm)). Confidence filtering
    happens downstream (YOLODetector._postprocess)."""
    dev = out["boxes"][0].device
    anchors, strd = make_anchors(out["shapes"], strides, device=dev)
    B = out["boxes"][0].shape[0]
    ltrb = dfl_decode(_rows(out["boxes"], B), reg_max)
    boxes = dist2bbox(ltrb, anchors, strd)
    scores = torch.sigmoid(_rows(out["classes"], B))
    conf, clid = scores.max(-1)
    decoded = {"boxes": boxes, "conf": conf, "clid": clid,
               "scores": scores}
    if "keypoints" in out:
        kp_flat = _rows(out["keypoints"], B)
        nk = kp_flat.shape[-1] // 3
        kp = kp_flat.reshape(B, -1, nk, 3)
        kx = (kp[..., 0] * 2.0 + (anchors[None, :, None, 0] - 0.5)) \
            * strd[None, :, None]
        ky = (kp[..., 1] * 2.0 + (anchors[None, :, None, 1] - 0.5)) \
            * strd[None, :, None]
        kconf = torch.sigmoid(kp[..., 2])
        decoded["keypoints"] = torch.stack([kx, ky, kconf], -1)
    if "mask_coeffs" in out:
        decoded["mask_coeffs"] = _rows(out["mask_coeffs"], B)
        decoded["proto"] = out["proto"].float().permute(0, 2, 3, 1)
    if "angles" in out:
        # OBB decode (ultralytics dist2rbox): the ltrb distances are in
        # the box's own rotated frame
        ang = _rows(out["angles"], B)[..., 0]
        ang = (torch.sigmoid(ang) - 0.25) * math.pi
        lt, rb = ltrb[..., :2], ltrb[..., 2:]
        off = (rb - lt) / 2.0
        cos, sin = torch.cos(ang), torch.sin(ang)
        cx = (off[..., 0] * cos - off[..., 1] * sin
              + anchors[None, :, 0]) * strd[None, :]
        cy = (off[..., 0] * sin + off[..., 1] * cos
              + anchors[None, :, 1]) * strd[None, :]
        bw = (lt[..., 0] + rb[..., 0]) * strd[None, :]
        bh = (lt[..., 1] + rb[..., 1]) * strd[None, :]
        decoded["obb"] = torch.stack([cx, cy, bw, bh, ang], -1)
        ex = torch.abs(bw / 2 * cos) + torch.abs(bh / 2 * sin)
        ey = torch.abs(bw / 2 * sin) + torch.abs(bh / 2 * cos)
        decoded["boxes"] = torch.stack(
            [cx - ex, cy - ey, cx + ex, cy + ey], -1)
    return decoded
