"""Official-zoo backbones for visual identification (counterpart of
``trex_tpu/models/backbones.py``).

The reference's `ModelFetcher` serves torchvision backbones with the
first conv re-fit to the crop's channel count and a fresh classifier
head (visual_identification_network_torch.py:389-560; the keras-era
table at visual_identification_network.py:205-482 additionally had
xception). These are the JAX package's flax re-implementations of the
same architectures, as torch modules over NCHW tensors that compute
what the flax modules compute (``layers.py``): bfloat16 convolution and
dense compute with float32 normalization, the zoo's x/127.5-1 input
Lambda, and a GAP + Dense(num_classes) head. Train mode (``train=True``)
uses the batch statistics with flax's default momentum 0.99 and the
head dropouts of the flax modules.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F

from .layers import (BatchNorm, Compact, Conv, Dense, LayerNorm, avg_pool,
                     gelu, max_pool)
from .vi_network import _Net, scale_input

relu = torch.relu


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def hard_sigmoid(x):
    return F.relu6(x + 3.0) / 6.0


def hard_swish(x):
    return x * hard_sigmoid(x)


def silu(x):
    """flax ``nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


class ConvBN(Compact):
    """conv -> BN -> activation, the building block of every classical
    backbone here."""

    def __init__(self, features: int, kernel: Any = 3, stride: int = 1,
                 groups: int = 1, padding: Any = "SAME", act: Any = relu,
                 use_bias: bool = False, dtype=torch.bfloat16):
        super().__init__()
        self.features, self.kernel, self.stride = features, kernel, stride
        self.groups, self.padding, self.act = groups, padding, act
        self.use_bias, self.dtype = use_bias, dtype

    def forward(self, x):
        x = self.child(Conv, x.shape[1], self.features, self.kernel,
                       self.stride, self.padding, self.groups,
                       self.use_bias, self.dtype)(x)
        x = self.child(BatchNorm, self.features)(x)
        return self.act(x) if self.act is not None else x


class SqueezeExcite(Compact):
    """Squeeze-and-excitation over the channels."""

    def __init__(self, reduce: int, gate: Any = torch.sigmoid,
                 act: Any = relu, dtype=torch.bfloat16):
        super().__init__()
        self.reduce, self.gate, self.act, self.dtype = \
            reduce, gate, act, dtype

    def forward(self, x):
        c = x.shape[1]
        s = x.mean(dim=(2, 3))
        s = self.act(self.child(Dense, c, self.reduce, self.dtype)(s))
        s = self.gate(self.child(Dense, self.reduce, c, self.dtype)(s))
        return x * s[:, :, None, None]


# ---------------------------------------------------------------- ResNet18
class _BasicBlock(Compact):
    def __init__(self, features: int, stride: int = 1, dtype=torch.bfloat16):
        super().__init__()
        self.features, self.stride, self.dtype = features, stride, dtype

    def forward(self, x):
        f, d = self.features, self.dtype
        y = self.child(ConvBN, f, 3, self.stride, dtype=d)(x)
        y = self.child(ConvBN, f, 3, 1, act=None, dtype=d)(y)
        if self.stride > 1 or x.shape[1] != f:
            x = self.child(ConvBN, f, 1, self.stride, act=None, dtype=d)(x)
        return relu(x + y)


class ResNet18(_Net):
    """resnet_18 (torchvision models.resnet18, basic blocks, v1)."""

    def forward(self, x):
        d = self.dtype
        x = scale_input(x, d)
        x = self.child(ConvBN, 64, 7, 2, dtype=d)(x)
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        for f, n, s in ((64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)):
            for i in range(n):
                x = self.child(_BasicBlock, f, s if i == 0 else 1, d)(x)
        return self.head(x.mean(dim=(2, 3)))


# ----------------------------------------------------------- EfficientNetB0
class _MBConv(Compact):
    def __init__(self, expand: int, features: int, kernel: int, stride: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.expand, self.features = expand, features
        self.kernel, self.stride, self.dtype = kernel, stride, dtype

    def forward(self, x):
        d = self.dtype
        inp = x.shape[1]
        y = x
        mid = inp * self.expand
        if self.expand != 1:
            y = self.child(ConvBN, mid, 1, act=silu, dtype=d)(y)
        y = self.child(ConvBN, mid, self.kernel, self.stride, groups=mid,
                       act=silu, dtype=d)(y)
        y = self.child(SqueezeExcite, max(1, inp // 4), act=silu,
                       dtype=d)(y)
        y = self.child(ConvBN, self.features, 1, act=None, dtype=d)(y)
        if self.stride == 1 and inp == self.features:
            y = x + y
        return y


class EfficientNetB0(_Net):
    """efficientnet_b0 (MBConv stages with SE, SiLU)."""

    # (expand, out, kernel, stride, repeats)
    stages: Sequence = ((1, 16, 3, 1, 1), (6, 24, 3, 2, 2),
                        (6, 40, 5, 2, 2), (6, 80, 3, 2, 3),
                        (6, 112, 5, 1, 3), (6, 192, 5, 2, 4),
                        (6, 320, 3, 1, 1))

    def forward(self, x):
        d = self.dtype
        x = scale_input(x, d)
        x = self.child(ConvBN, 32, 3, 2, act=silu, dtype=d)(x)
        for expand, out, k, s, r in self.stages:
            for i in range(r):
                x = self.child(_MBConv, expand, out, k, s if i == 0 else 1,
                               d)(x)
        x = self.child(ConvBN, 1280, 1, act=silu, dtype=d)(x)
        return self.head(self.dropout(x.mean(dim=(2, 3)), 0.2))


# ------------------------------------------------------------- MobileNetV3
class _MNV3Block(Compact):
    def __init__(self, kernel: int, exp: int, features: int, se: bool,
                 hs: bool, stride: int, dtype=torch.bfloat16):
        super().__init__()
        self.kernel, self.exp, self.features = kernel, exp, features
        self.se, self.hs, self.stride, self.dtype = se, hs, stride, dtype

    def forward(self, x):
        d = self.dtype
        act = hard_swish if self.hs else relu
        inp = x.shape[1]
        y = x
        if self.exp != inp:
            y = self.child(ConvBN, self.exp, 1, act=act, dtype=d)(y)
        y = self.child(ConvBN, self.exp, self.kernel, self.stride,
                       groups=self.exp, act=act, dtype=d)(y)
        if self.se:
            y = self.child(SqueezeExcite, _make_divisible(self.exp / 4),
                           gate=hard_sigmoid, dtype=d)(y)
        y = self.child(ConvBN, self.features, 1, act=None, dtype=d)(y)
        if self.stride == 1 and inp == self.features:
            y = x + y
        return y


_MNV3_SMALL = (  # (kernel, exp, out, SE, HS, stride)
    (3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1))

_MNV3_LARGE = (
    (3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
    (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
    (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
    (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
    (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
    (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
    (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
    (5, 960, 160, True, True, 1))


class MobileNetV3(_Net):
    """mobilenet_v3_small / mobilenet_v3_large."""

    def __init__(self, num_classes: int, small: bool = True,
                 dtype=torch.bfloat16):
        super().__init__(num_classes, dtype)
        self.small = small

    def forward(self, x):
        d = self.dtype
        x = scale_input(x, d)
        x = self.child(ConvBN, 16, 3, 2, act=hard_swish, dtype=d)(x)
        for k, exp, out, se, hs, s in (_MNV3_SMALL if self.small
                                       else _MNV3_LARGE):
            x = self.child(_MNV3Block, k, exp, out, se, hs, s, d)(x)
        last = 576 if self.small else 960
        head = 1024 if self.small else 1280
        x = self.child(ConvBN, last, 1, act=hard_swish, dtype=d)(x)
        x = hard_swish(self.dense(x.mean(dim=(2, 3)), head))
        return self.head(self.dropout(x, 0.2))


# ------------------------------------------------------------ ConvNeXtBase
def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


class _ConvNeXtBlock(Compact):
    def __init__(self, dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dim, self.dtype = dim, dtype

    def forward(self, x):
        d, dim = self.dtype, self.dim
        y = self.child(Conv, dim, dim, 7, groups=dim, dtype=d)(x)
        y = self.child(LayerNorm, dim)(_nhwc(y))
        y = gelu(self.child(Dense, dim, 4 * dim, d)(y))
        y = self.child(Dense, 4 * dim, dim, d)(y)
        gamma = self.param("layer_scale", (dim,), "const1e-6")
        return x + _nchw(y * gamma.to(y.dtype))


class ConvNeXtBase(_Net):
    """convnext_base: patchify stem, depthwise 7x7 blocks, LayerNorm,
    layer-scale residuals; depths (3,3,27,3), dims (128,256,512,1024)."""

    def __init__(self, num_classes: int, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024),
                 dtype=torch.bfloat16):
        super().__init__(num_classes, dtype)
        self.depths, self.dims = depths, dims

    def _ln(self, x):
        return _nchw(self.child(LayerNorm, x.shape[1])(_nhwc(x)))

    def forward(self, x):
        d = self.dtype
        x = scale_input(x, d)
        x = self.conv(x, self.dims[0], 4, strides=4)
        x = self._ln(x)
        for i, (depth, dim) in enumerate(zip(self.depths, self.dims)):
            if i > 0:
                x = self._ln(x)
                x = self.conv(x, dim, 2, strides=2)
            for _ in range(depth):
                x = self.child(_ConvNeXtBlock, dim, d)(x)
        x = x.mean(dim=(2, 3))
        x = self.child(LayerNorm, x.shape[1])(x)
        return self.head(x)


# ------------------------------------------------------------- InceptionV3
def _cat(xs):
    return torch.cat(xs, dim=1)


class _InceptionA(Compact):
    def __init__(self, pool_features: int, dtype=torch.bfloat16):
        super().__init__()
        self.pool_features, self.dtype = pool_features, dtype

    def forward(self, x):
        d = self.dtype
        b1 = self.child(ConvBN, 64, 1, dtype=d)(x)
        b2 = self.child(ConvBN, 48, 1, dtype=d)(x)
        b2 = self.child(ConvBN, 64, 5, dtype=d)(b2)
        b3 = self.child(ConvBN, 64, 1, dtype=d)(x)
        b3 = self.child(ConvBN, 96, 3, dtype=d)(b3)
        b3 = self.child(ConvBN, 96, 3, dtype=d)(b3)
        b4 = avg_pool(x, 3, 1, "SAME")
        b4 = self.child(ConvBN, self.pool_features, 1, dtype=d)(b4)
        return _cat([b1, b2, b3, b4])


class _InceptionB(Compact):  # grid reduction 35 -> 17
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        b1 = self.child(ConvBN, 384, 3, 2, padding="VALID", dtype=d)(x)
        b2 = self.child(ConvBN, 64, 1, dtype=d)(x)
        b2 = self.child(ConvBN, 96, 3, dtype=d)(b2)
        b2 = self.child(ConvBN, 96, 3, 2, padding="VALID", dtype=d)(b2)
        b3 = max_pool(x, 3, 2)
        return _cat([b1, b2, b3])


class _Conv7x1(Compact):
    def __init__(self, features: int, flip: bool = False,
                 dtype=torch.bfloat16):
        super().__init__()
        self.features, self.flip, self.dtype = features, flip, dtype

    def forward(self, x):
        k = (1, 7) if self.flip else (7, 1)
        x = self.child(Conv, x.shape[1], self.features, k, use_bias=False,
                       dtype=self.dtype)(x)
        return relu(self.child(BatchNorm, self.features)(x))


class _InceptionC(Compact):
    def __init__(self, c7: int, dtype=torch.bfloat16):
        super().__init__()
        self.c7, self.dtype = c7, dtype

    def forward(self, x):
        d, c7 = self.dtype, self.c7
        b1 = self.child(ConvBN, 192, 1, dtype=d)(x)
        b2 = self.child(ConvBN, c7, 1, dtype=d)(x)
        b2 = self.child(_Conv7x1, c7, flip=True, dtype=d)(b2)
        b2 = self.child(_Conv7x1, 192, dtype=d)(b2)
        b3 = self.child(ConvBN, c7, 1, dtype=d)(x)
        b3 = self.child(_Conv7x1, c7, dtype=d)(b3)
        b3 = self.child(_Conv7x1, c7, flip=True, dtype=d)(b3)
        b3 = self.child(_Conv7x1, c7, dtype=d)(b3)
        b3 = self.child(_Conv7x1, 192, flip=True, dtype=d)(b3)
        b4 = avg_pool(x, 3, 1, "SAME")
        b4 = self.child(ConvBN, 192, 1, dtype=d)(b4)
        return _cat([b1, b2, b3, b4])


class _InceptionD(Compact):  # grid reduction 17 -> 8
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        d = self.dtype
        b1 = self.child(ConvBN, 192, 1, dtype=d)(x)
        b1 = self.child(ConvBN, 320, 3, 2, padding="VALID", dtype=d)(b1)
        b2 = self.child(ConvBN, 192, 1, dtype=d)(x)
        b2 = self.child(_Conv7x1, 192, flip=True, dtype=d)(b2)
        b2 = self.child(_Conv7x1, 192, dtype=d)(b2)
        b2 = self.child(ConvBN, 192, 3, 2, padding="VALID", dtype=d)(b2)
        b3 = max_pool(x, 3, 2)
        return _cat([b1, b2, b3])


class _InceptionE(Compact):
    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype

    def _split(self, x):
        """relu(concat(BN(conv 1x3), BN(conv 3x1)))."""
        d = self.dtype
        a = self.child(Conv, x.shape[1], 384, (1, 3), use_bias=False,
                       dtype=d)(x)
        a = self.child(BatchNorm, 384)(a)
        b = self.child(Conv, x.shape[1], 384, (3, 1), use_bias=False,
                       dtype=d)(x)
        b = self.child(BatchNorm, 384)(b)
        return relu(_cat([a, b]))

    def forward(self, x):
        d = self.dtype
        b1 = self.child(ConvBN, 320, 1, dtype=d)(x)
        b2 = self._split(self.child(ConvBN, 384, 1, dtype=d)(x))
        b3 = self.child(ConvBN, 448, 1, dtype=d)(x)
        b3 = self._split(self.child(ConvBN, 384, 3, dtype=d)(b3))
        b4 = avg_pool(x, 3, 1, "SAME")
        b4 = self.child(ConvBN, 192, 1, dtype=d)(b4)
        return _cat([b1, b2, b3, b4])


class InceptionV3(_Net):
    """inception_v3 (torchvision structure; SAME-padded stem so the
    80x80 identity crops keep a workable grid)."""

    def forward(self, x):
        d = self.dtype
        x = scale_input(x, d)
        x = self.child(ConvBN, 32, 3, 2, dtype=d)(x)
        x = self.child(ConvBN, 32, 3, dtype=d)(x)
        x = self.child(ConvBN, 64, 3, dtype=d)(x)
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        x = self.child(ConvBN, 80, 1, dtype=d)(x)
        x = self.child(ConvBN, 192, 3, dtype=d)(x)
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        for pf in (32, 64, 64):
            x = self.child(_InceptionA, pf, d)(x)
        x = self.child(_InceptionB, d)(x)
        for c7 in (128, 160, 160, 192):
            x = self.child(_InceptionC, c7, d)(x)
        x = self.child(_InceptionD, d)(x)
        x = self.child(_InceptionE, d)(x)
        x = self.child(_InceptionE, d)(x)
        return self.head(self.dropout(x.mean(dim=(2, 3)), 0.5))


# ---------------------------------------------------------------- Xception
class _SepConvBN(Compact):
    def __init__(self, features: int, dtype=torch.bfloat16):
        super().__init__()
        self.features, self.dtype = features, dtype

    def forward(self, x):
        c = x.shape[1]
        x = self.child(Conv, c, c, 3, groups=c, use_bias=False,
                       dtype=self.dtype)(x)
        x = self.child(Conv, c, self.features, 1, use_bias=False,
                       dtype=self.dtype)(x)
        return self.child(BatchNorm, self.features)(x)


class _XceptionBlock(Compact):
    def __init__(self, features: int, relu_first: bool = True,
                 pool: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.features, self.relu_first = features, relu_first
        self.pool, self.dtype = pool, dtype

    def forward(self, x):
        f, d = self.features, self.dtype
        shortcut = x
        if self.pool or x.shape[1] != f:
            shortcut = self.child(Conv, x.shape[1], f, 1,
                                  2 if self.pool else 1, use_bias=False,
                                  dtype=d)(x)
            shortcut = self.child(BatchNorm, f)(shortcut)
        y = x
        for i in range(3 if not self.pool else 2):
            if i > 0 or self.relu_first:
                y = relu(y)
            y = self.child(_SepConvBN, f, d)(y)
        if self.pool:
            y = max_pool(y, 3, 2, ((1, 1), (1, 1)))
        return y + shortcut


class Xception(_Net):
    """xception (keras-era zoo entry): entry flow, 8 middle-flow
    blocks, exit flow; separable convs throughout."""

    def forward(self, x):
        d = self.dtype
        x = scale_input(x, d)
        x = self.child(ConvBN, 32, 3, 2, dtype=d)(x)
        x = self.child(ConvBN, 64, 3, dtype=d)(x)
        x = self.child(_XceptionBlock, 128, relu_first=False, dtype=d)(x)
        x = self.child(_XceptionBlock, 256, dtype=d)(x)
        x = self.child(_XceptionBlock, 728, dtype=d)(x)
        for _ in range(8):
            x = self.child(_XceptionBlock, 728, pool=False, dtype=d)(x)
        # exit flow
        shortcut = self.conv(x, 1024, 1, strides=2, use_bias=False)
        shortcut = self.child(BatchNorm, 1024)(shortcut)
        y = self.child(_SepConvBN, 728, d)(relu(x))
        y = self.child(_SepConvBN, 1024, d)(relu(y))
        y = max_pool(y, 3, 2, ((1, 1), (1, 1)))
        x = y + shortcut
        x = relu(self.child(_SepConvBN, 1536, d)(x))
        x = relu(self.child(_SepConvBN, 2048, d)(x))
        return self.head(x.mean(dim=(2, 3)))


# ------------------------------------------------------------ NASNetMobile
def _correct_pad(h: int, w: int, k: int):
    """keras imagenet_utils.correct_pad for stride-2 VALID convs:
    ((top, bottom), (left, right))."""
    adj = (1 - h % 2, 1 - w % 2)
    c = k // 2
    return ((c - adj[0], c), (c - adj[1], c))


def _pad(x, pads):
    (t, b), (l, r) = pads
    return F.pad(x, (l, r, t, b))


class _NASSepConv(Compact):
    """NASNet separable-conv block: two rounds of
    relu -> depthwise+pointwise -> BN (keras _separable_conv_block)."""

    def __init__(self, filters: int, kernel: int = 3, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.filters, self.kernel, self.stride, self.dtype = \
            filters, kernel, stride, dtype

    def forward(self, x):
        d, k, f = self.dtype, self.kernel, self.filters
        x = relu(x)
        if self.stride == 2:
            x = _pad(x, _correct_pad(x.shape[2], x.shape[3], k))
            pad = "VALID"
        else:
            pad = "SAME"
        c = x.shape[1]
        x = self.child(Conv, c, c, k, self.stride, pad, c, False, d)(x)
        x = self.child(Conv, c, f, 1, use_bias=False, dtype=d)(x)
        x = relu(self.child(BatchNorm, f, 1e-3)(x))
        c = x.shape[1]
        x = self.child(Conv, c, c, k, groups=c, use_bias=False, dtype=d)(x)
        x = self.child(Conv, c, f, 1, use_bias=False, dtype=d)(x)
        return self.child(BatchNorm, f, 1e-3)(x)


class _NASAdjust(Compact):
    """keras _adjust_block: match the previous path p to the current
    input's spatial size / channel count (factorized reduction)."""

    def __init__(self, filters: int, dtype=torch.bfloat16):
        super().__init__()
        self.filters, self.dtype = filters, dtype

    def forward(self, p, ip):
        f, d = self.filters, self.dtype
        if p.shape[2] != ip.shape[2]:
            p = relu(p)
            p1 = p[:, :, ::2, ::2]
            p1 = self.child(Conv, p1.shape[1], f // 2, 1, use_bias=False,
                            dtype=d)(p1)
            # pad bottom/right, crop top/left: one-pixel diagonal shift
            p2 = F.pad(p, (0, 1, 0, 1))[:, :, 1:, 1:]
            p2 = p2[:, :, ::2, ::2]
            p2 = self.child(Conv, p2.shape[1], f // 2, 1, use_bias=False,
                            dtype=d)(p2)
            p = _cat([p1, p2])
            p = self.child(BatchNorm, p.shape[1], 1e-3)(p)
        elif p.shape[1] != f:
            p = relu(p)
            p = self.child(Conv, p.shape[1], f, 1, use_bias=False,
                           dtype=d)(p)
            p = self.child(BatchNorm, f, 1e-3)(p)
        return p


class _NASNormalCell(Compact):
    def __init__(self, filters: int, dtype=torch.bfloat16):
        super().__init__()
        self.filters, self.dtype = filters, dtype

    def forward(self, x, p):
        d, f = self.dtype, self.filters
        ip = x
        # keras _adjust_block: a None previous path passes through as
        # ip itself, unprojected
        p = ip if p is None else self.child(_NASAdjust, f, d)(p, ip)
        h = relu(ip)
        h = self.child(Conv, h.shape[1], f, 1, use_bias=False, dtype=d)(h)
        h = self.child(BatchNorm, f, 1e-3)(h)
        sep = lambda k, v: self.child(_NASSepConv, f, k, dtype=d)(v)
        x1 = sep(5, h) + sep(3, p)
        x2 = sep(5, p) + sep(3, p)
        x3 = avg_pool(h, 3, 1, "SAME") + p
        x4 = avg_pool(p, 3, 1, "SAME") + avg_pool(p, 3, 1, "SAME")
        x5 = sep(3, h) + h
        return _cat([p, x1, x2, x3, x4, x5]), ip


class _NASReductionCell(Compact):
    def __init__(self, filters: int, dtype=torch.bfloat16):
        super().__init__()
        self.filters, self.dtype = filters, dtype

    def forward(self, x, p):
        d, f = self.dtype, self.filters
        ip = x
        p = ip if p is None else self.child(_NASAdjust, f, d)(p, ip)
        h = relu(ip)
        h = self.child(Conv, h.shape[1], f, 1, use_bias=False, dtype=d)(h)
        h = self.child(BatchNorm, f, 1e-3)(h)
        h3 = _pad(h, _correct_pad(h.shape[2], h.shape[3], 3))
        sep = lambda k, s, v: self.child(_NASSepConv, f, k, s, d)(v)
        x1 = sep(5, 2, h) + sep(7, 2, p)
        x2 = max_pool(h3, 3, 2) + sep(7, 2, p)
        x3 = avg_pool(h3, 3, 2) + sep(5, 2, p)
        x4 = x2 + avg_pool(x1, 3, 1, "SAME")
        x5 = sep(3, 1, x1) + max_pool(h3, 3, 2)
        return _cat([x2, x3, x4, x5]), ip


class NASNetMobile(_Net):
    """nasnetmobile (keras-era zoo entry): NASNet-A (4 @ 1056),
    penultimate 1056 -> filters 44, stem 32, filter multiplier 2."""

    def __init__(self, num_classes: int, num_blocks: int = 4,
                 filters: int = 44, dtype=torch.bfloat16):
        super().__init__(num_classes, dtype)
        self.num_blocks, self.filters = num_blocks, filters

    def forward(self, x):
        d, f = self.dtype, self.filters
        x = scale_input(x, d)
        x = self.conv(x, 32, 3, strides=2, padding="VALID", use_bias=False)
        x = self.child(BatchNorm, 32, 1e-3)(x)
        p = None  # keras: first cell's previous path is ip itself
        x, p = self.child(_NASReductionCell, f // 4, d)(x, p)
        x, p = self.child(_NASReductionCell, f // 2, d)(x, p)
        for mult in (1, 2, 4):
            if mult > 1:
                x, p = self.child(_NASReductionCell, f * mult, d)(x, p)
            for _ in range(self.num_blocks):
                x, p = self.child(_NASNormalCell, f * mult, d)(x, p)
        x = relu(x)
        return self.head(x.mean(dim=(2, 3)))
