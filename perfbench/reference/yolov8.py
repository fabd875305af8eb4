"""YOLOv8 in plain PyTorch, float32, in ultralytics' module layout.

The benchmark's reference for the YOLOv8 configurations. It imports
nothing of the program under test. Its module tree carries ultralytics'
names (``model.0`` .. ``model.22``; the head's ``cv2``/``cv3``/``cv4``
and ``dfl``), so ``torch.save({"model": model.half()}, path)`` writes a
checkpoint in the layout a user's ``.pt`` file has, and the same weights
run here.

The architecture follows ``ultralytics/cfg/models/v8/yolov8{,-pose,-obb}
.yaml`` and ultralytics' modules (``Conv``, ``C2f``, ``Bottleneck``,
``SPPF``, ``Detect``/``Pose``/``OBB``). The decode is ultralytics'
inference path: DFL expectation, ``dist2bbox`` (xyxy) or ``dist2rbox``,
sigmoid scores, ``kpts_decode``.

Modes, set on every block by :func:`set_mode`:

- ``calibrate``: each BatchNorm's statistics become its input batch's
  mean and, as its variance, the batch's biased variance plus its mean
  square (the benchmark's stand-in for a trained model's statistics,
  which come from data more varied than one scene: a channel nearly
  constant over the scene's uniform floor is not scaled up by the
  inverse of its tiny spread, which would amplify every rounding on
  its way to the head);
- ``fp8``: each Conv's input and weight are rounded to float8 e4m3 with
  one scale a tensor (amax / 448) before a float32 product: the
  precision control, one step below the bfloat16 the configuration
  states.

Float32 products run without TF32 (the caller's ``no_tf32``).
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn as nn
import torch.nn.functional as F

SCALES = {  # depth, width, max_channels (ultralytics yolov8 scales)
    "n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768), "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}
STRIDES = (8, 16, 32)
REG_MAX = 16
FP8_MAX = 448.0


@contextmanager
def no_tf32():
    """Float32 products in float32 (TF32 off) inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """`t` through float8 e4m3 with one scale for the tensor."""
    scale = t.abs().amax().clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Conv(nn.Module):
    """ultralytics ``Conv``: Conv2d (no bias), BatchNorm2d, SiLU."""

    def __init__(self, c1, c2, k=1, s=1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.calibrate = False
        self.fp8 = False

    def forward(self, x):
        w = self.conv.weight.float()
        x = x.float()
        if self.fp8:
            x, w = fp8_round(x), fp8_round(w)
        y = F.conv2d(x, w, None, self.conv.stride, self.conv.padding)
        bn = self.bn
        if self.calibrate:
            bn.running_mean.copy_(y.mean((0, 2, 3)))
            bn.running_var.copy_(y.var((0, 2, 3), unbiased=False)
                                 + y.square().mean((0, 2, 3)))
        y = F.batch_norm(y, bn.running_mean.float(), bn.running_var.float(),
                         bn.weight.float(), bn.bias.float(), False, 0.0,
                         bn.eps)
        return F.silu(y)


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True):
        super().__init__()
        self.cv1 = Conv(c1, c2, 3)
        self.cv2 = Conv(c2, c2, 3)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=False):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut)
                               for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * 4, c2, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(self.m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class DFL(nn.Module):
    """ultralytics ``DFL``: its fixed 1x1 convolution holds the bins."""

    def __init__(self, c1=REG_MAX):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        self.conv.weight.data[:] = torch.arange(
            c1, dtype=torch.float32).view(1, c1, 1, 1)


def _branches(chs, c_mid, n_out):
    return nn.ModuleList(nn.Sequential(Conv(c, c_mid, 3),
                                       Conv(c_mid, c_mid, 3),
                                       nn.Conv2d(c_mid, n_out, 1))
                         for c in chs)


class Head(nn.Module):
    """``Detect`` with ``Pose``'s or ``OBB``'s third branch (``cv4``)."""

    def __init__(self, nc, chs, task, nk=0):
        super().__init__()
        self.cv2 = _branches(chs, max(16, chs[0] // 4, REG_MAX * 4),
                             4 * REG_MAX)
        self.cv3 = _branches(chs, max(chs[0], min(nc, 100)), nc)
        self.dfl = DFL(REG_MAX)
        n_out = {"pose": nk, "obb": 1}.get(task)
        if n_out is not None:
            self.cv4 = _branches(chs, max(chs[0] // 4, n_out), n_out)

    def forward(self, feats):
        out = {"box": [b(f) for b, f in zip(self.cv2, feats)],
               "cls": [b(f) for b, f in zip(self.cv3, feats)],
               "shapes": [tuple(f.shape[2:]) for f in feats]}
        if hasattr(self, "cv4"):
            out["extra"] = [b(f) for b, f in zip(self.cv4, feats)]
        return out


class YOLOv8(nn.Module):
    """The network: ``self.model`` is ultralytics' layer list."""

    def __init__(self, scale="x", task="detect", nc=80, kpt_shape=(17, 3)):
        super().__init__()
        depth, width, maxc = SCALES[scale]
        self.task = task
        self.kpt_shape = tuple(kpt_shape)

        def ch(c):
            return int(math.ceil(min(c, maxc) * width / 8) * 8)

        def nd(n):
            return max(round(n * depth), 1)

        c = [ch(64), ch(128), ch(256), ch(512), ch(1024)]
        nk = self.kpt_shape[0] * self.kpt_shape[1] if task == "pose" else 0
        layers = [
            Conv(3, c[0], 3, 2), Conv(c[0], c[1], 3, 2),
            C2f(c[1], c[1], nd(3), True), Conv(c[1], c[2], 3, 2),
            C2f(c[2], c[2], nd(6), True), Conv(c[2], c[3], 3, 2),
            C2f(c[3], c[3], nd(6), True), Conv(c[3], c[4], 3, 2),
            C2f(c[4], c[4], nd(3), True), SPPF(c[4], c[4], 5),
            nn.Upsample(None, 2, "nearest"), nn.Identity(),
            C2f(c[4] + c[3], c[3], nd(3)), nn.Upsample(None, 2, "nearest"),
            nn.Identity(), C2f(c[3] + c[2], c[2], nd(3)),
            Conv(c[2], c[2], 3, 2), nn.Identity(),
            C2f(c[2] + c[3], c[3], nd(3)), Conv(c[3], c[3], 3, 2),
            nn.Identity(), C2f(c[3] + c[4], c[4], nd(3)),
            Head(nc, [c[2], c[3], c[4]], task, nk)]
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        """(B, 3, H, W) pixel values 0-255 -> the head's raw maps."""
        m = self.model
        x = x.float() / 255.0
        x = m[2](m[1](m[0](x)))
        p3 = m[4](m[3](x))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        n4 = m[12](torch.cat([m[10](p5), p4], 1))
        n3 = m[15](torch.cat([m[13](n4), p3], 1))
        n4b = m[18](torch.cat([m[16](n3), n4], 1))
        n5 = m[21](torch.cat([m[19](n4b), p5], 1))
        return m[22]([n3, n4b, n5])


def set_mode(model: nn.Module, calibrate: bool = False,
             fp8: bool = False) -> nn.Module:
    for mod in model.modules():
        if isinstance(mod, Conv):
            mod.calibrate, mod.fp8 = calibrate, fp8
    return model


def _rows(maps, B):
    """Per-level (B, C, h, w) -> (B, sum h*w, C), level-major rows."""
    return torch.cat([m.float().flatten(2).transpose(1, 2) for m in maps], 1)


def anchors_for(shapes, device):
    pts, strides = [], []
    for (h, w), s in zip(shapes, STRIDES):
        ys, xs = torch.meshgrid(torch.arange(h, device=device) + 0.5,
                                torch.arange(w, device=device) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([xs.flatten(), ys.flatten()], -1).float())
        strides.append(torch.full((h * w,), float(s), device=device))
    return torch.cat(pts), torch.cat(strides)


def decode(out: dict, task: str, kpt_shape=(17, 3)) -> dict:
    """ultralytics' inference decode of :meth:`YOLOv8.forward`'s maps:
    ``boxes`` xyxy (axis-aligned extents for OBB), ``conf`` and ``clid``
    (best class), ``logit`` (its pre-sigmoid score), and ``keypoints``
    (B, N, K, 3) or ``obb`` (B, N, 5: cx, cy, w, h, angle in rad), in
    input pixels."""
    B = out["box"][0].shape[0]
    anchors, stride = anchors_for(out["shapes"], out["box"][0].device)
    box = _rows(out["box"], B).view(B, -1, 4, REG_MAX).softmax(-1)
    ltrb = box @ torch.arange(REG_MAX, dtype=torch.float32,
                              device=box.device)
    logit, clid = _rows(out["cls"], B).max(-1)
    res = {"conf": torch.sigmoid(logit), "logit": logit, "clid": clid}
    st = stride[None, :, None]
    if task == "obb":
        ang = (torch.sigmoid(_rows(out["extra"], B)[..., 0]) - 0.25) * math.pi
        lt, rb = ltrb[..., :2], ltrb[..., 2:]
        xf, yf = ((rb - lt) / 2).unbind(-1)
        cos, sin = ang.cos(), ang.sin()
        xy = torch.stack([xf * cos - yf * sin, xf * sin + yf * cos], -1)
        xy = (xy + anchors) * st
        wh = (lt + rb) * st
        res["obb"] = torch.cat([xy, wh, ang[..., None]], -1)
        ex = (wh[..., 0] / 2 * cos).abs() + (wh[..., 1] / 2 * sin).abs()
        ey = (wh[..., 0] / 2 * sin).abs() + (wh[..., 1] / 2 * cos).abs()
        res["boxes"] = torch.stack([xy[..., 0] - ex, xy[..., 1] - ey,
                                    xy[..., 0] + ex, xy[..., 1] + ey], -1)
    else:
        res["boxes"] = torch.cat([anchors - ltrb[..., :2],
                                  anchors + ltrb[..., 2:]], -1) * st
    if task == "pose":
        k, d = kpt_shape
        kp = _rows(out["extra"], B).view(B, -1, k, d)
        a = anchors[None, :, None]
        s = stride[None, :, None]
        xy = (kp[..., :2] * 2.0 + (a - 0.5)) * s[..., None]
        parts = [xy]
        if d == 3:
            parts.append(torch.sigmoid(kp[..., 2:3]))
        res["keypoints"] = torch.cat(parts, -1)
    return res
