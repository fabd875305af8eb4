"""Visual-identification network zoo (counterpart of
``trex_tpu/models/vi_network.py``).

The reference's torch/keras model zoo keyed by
`visual_identification_version` (reference
python/visual_identification_network_torch.py: V118_3 :184-250,
V119 :106-180, V200 :30-104; keras table
visual_identification_network.py:205-482), as torch modules over NCHW
tensors that compute what the JAX package's flax modules compute
(``layers.py``: flax's names, dtype policy, padding and normalization).
Inputs are uint8-valued crops (individual_image_size, default 80x80, 1
channel), cast to the compute type before ``x/127.5 - 1``; convolutions
and hidden dense layers compute in bfloat16, normalization and the last
dense layer in float32, parameters are float32. Called with
``train=True`` (and a dropout generator as ``rng``), a network applies
the dropouts and batch statistics its flax module applies, in the same
order (``layers.py``).

:func:`build` returns the module unmade; ``layers.materialize`` makes
its children for an image shape and initializes them.
"""
from __future__ import annotations

from typing import Callable

import torch

from .layers import (BatchNorm, Compact, Conv, Dense, Dropout, LayerNorm,
                     MultiHeadDotProductAttention, flatten, gelu, max_pool)

relu = torch.relu


def scale_input(x, dtype):
    """The zoo's input Lambda: x/127.5 - 1 in the compute type."""
    return x.to(dtype) / 127.5 - 1.0


class ConvBlock(Compact):
    """conv -> BN -> relu -> max pool -> dropout."""

    def __init__(self, features: int, kernel: int, pool: int,
                 dropout: float, dtype=torch.bfloat16):
        super().__init__()
        self.features, self.kernel, self.pool = features, kernel, pool
        self.dropout, self.dtype = dropout, dtype

    def forward(self, x):
        x = self.child(Conv, x.shape[1], self.features, self.kernel,
                       dtype=self.dtype)(x)
        x = relu(self.child(BatchNorm, self.features, momentum=0.9)(x))
        if self.pool > 1:
            x = max_pool(x, self.pool, self.pool)
        if self.dropout > 0:
            x = self.child(Dropout, self.dropout)(x)
        return x


class _Net(Compact):
    def __init__(self, num_classes: int, dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype

    def dense(self, x, features, dtype=None, chw=None):
        return self.child(Dense, x.shape[-1], features,
                          dtype or self.dtype, chw)(x)

    def conv(self, x, features, kernel, **kw):
        return self.child(Conv, x.shape[1], features, kernel,
                          dtype=self.dtype, **kw)(x)

    def head(self, x):
        return self.dense(x, self.num_classes, torch.float32)

    def bn(self, x):
        """The networks' BatchNorm (flax momentum 0.9)."""
        return self.child(BatchNorm, x.shape[1], momentum=0.9)(x)

    def dropout(self, x, rate):
        return self.child(Dropout, rate)(x)


class V118_3(_Net):
    """Compact default VI network (visual_identification_version v118_3)."""

    def forward(self, x):
        x = scale_input(x, self.dtype)
        for f in (16, 64, 128):
            x = self.child(ConvBlock, f, 5, 2, 0.05, self.dtype)(x)
        x, chw = flatten(x)
        x = self.dense(x, 100, chw=chw)
        x = relu(self.child(LayerNorm, 100)(x))
        x = self.dropout(x, 0.05)
        return self.head(x)


class V110(_Net):
    """Shallow legacy CNN (v110): conv -> pool -> BN -> relu -> dropout
    stages."""

    def forward(self, x):
        x = scale_input(x, self.dtype)
        for feat in (16, 64, 100):
            x = self.conv(x, feat, 5)
            x = max_pool(x, 2, 2)
            x = self.dropout(relu(self.bn(x)), 0.25)
        x, chw = flatten(x)
        x = self.dense(x, 100, chw=chw)
        x = self.dropout(relu(self.bn(x)), 0.25)
        return self.head(x)


class V100(_Net):
    """The original layout (v100): conv -> relu -> pool -> dropout, no
    normalization."""

    def forward(self, x):
        x = scale_input(x, self.dtype)
        for feat in (16, 64, 100):
            x = max_pool(relu(self.conv(x, feat, 5)), 2, 2)
            x = self.dropout(x, 0.25)
        x, chw = flatten(x)
        x = self.dropout(relu(self.dense(x, 100, chw=chw)), 0.5)
        return self.head(x)


class V119(_Net):
    def forward(self, x):
        x = scale_input(x, self.dtype)
        for feat in (256, 128, 32, 128):
            x = self.child(ConvBlock, feat, 5, 2, 0.05, self.dtype)(x)
        x, chw = flatten(x)
        x = self.dense(x, 1024, chw=chw)
        x = relu(self.bn(x))
        return self.head(x)


class V200(_Net):
    def forward(self, x):
        x = scale_input(x, self.dtype)
        for f, p, d in ((64, 1, 0.0), (128, 3, 0.05), (256, 1, 0.0),
                        (512, 3, 0.25), (512, 3, 0.05)):
            x = self.child(ConvBlock, f, 3, p, d, self.dtype)(x)
        x = x.mean(dim=(2, 3))  # global average pool
        x = self.dense(x, 1024)
        x = self.dropout(relu(self.bn(x)), 0.05)
        return self.head(x)


class ViT(_Net):
    """Small vision transformer variant
    (visual_identification_network.py:118-203)."""

    def __init__(self, num_classes: int, patch: int = 10, dim: int = 128,
                 depth: int = 4, heads: int = 4, dtype=torch.bfloat16):
        super().__init__(num_classes, dtype)
        self.patch, self.dim, self.depth, self.heads = \
            patch, dim, depth, heads

    def forward(self, x):
        x = scale_input(x, self.dtype)
        b = x.shape[0]
        x = self.conv(x, self.dim, self.patch, strides=self.patch)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)
        pos = self.param("pos_embed", (1, x.shape[1], self.dim),
                         "normal0.02")
        x = x + pos.to(self.dtype)
        for _ in range(self.depth):
            y = self.child(LayerNorm, self.dim)(x)
            y = self.child(MultiHeadDotProductAttention, self.dim,
                           self.heads, self.dtype)(y)
            x = x + y
            y = self.child(LayerNorm, self.dim)(x)
            y = gelu(self.dense(y, self.dim * 4))
            y = self.dropout(self.dense(y, self.dim), 0.1)
            x = x + y
        x = self.child(LayerNorm, self.dim)(x)
        return self.head(x.mean(dim=1))


class SmallMLP(_Net):
    """Categorization MLP (reference trex_learn_category.py:18-153)."""

    def __init__(self, num_classes: int, hidden: int = 100,
                 dtype=torch.bfloat16):
        super().__init__(num_classes, dtype)
        self.hidden = hidden

    def forward(self, x):
        x = scale_input(x, self.dtype)
        x, chw = flatten(x)
        x = self.dropout(relu(self.dense(x, self.hidden, chw=chw)), 0.25)
        x = relu(self.dense(x, self.hidden))
        return self.head(x)


class VGG(_Net):
    """VGG16/19 backbone + the reference zoo's classification head
    (GAP + dense)."""

    def __init__(self, num_classes: int, blocks: tuple = (2, 2, 3, 3, 3),
                 dtype=torch.bfloat16):
        super().__init__(num_classes, dtype)
        self.blocks = blocks  # vgg16; vgg19 = (2,2,4,4,4)

    def forward(self, x):
        x = scale_input(x, self.dtype)
        for n, f in zip(self.blocks, (64, 128, 256, 512, 512)):
            for _ in range(n):
                x = relu(self.conv(x, f, 3))
            x = max_pool(x, 2, 2)
        x = x.mean(dim=(2, 3))  # GAP head
        x = self.dropout(relu(self.dense(x, 1024)), 0.05)
        return self.head(x)


class _BottleneckV2(Compact):
    """ResNet v2 pre-activation bottleneck."""

    def __init__(self, features: int, stride: int = 1,
                 dtype=torch.bfloat16):
        super().__init__()
        self.features, self.stride, self.dtype = features, stride, dtype

    def forward(self, x):
        f, s, d = self.features, self.stride, self.dtype
        pre = relu(self.child(BatchNorm, x.shape[1], momentum=0.9)(x))
        if s > 1 or x.shape[1] != f * 4:
            shortcut = self.child(Conv, pre.shape[1], f * 4, 1, s,
                                  dtype=d)(pre)
        else:
            shortcut = x
        y = self.child(Conv, pre.shape[1], f, 1, use_bias=False,
                       dtype=d)(pre)
        y = relu(self.child(BatchNorm, f, momentum=0.9)(y))
        y = self.child(Conv, f, f, 3, s, use_bias=False, dtype=d)(y)
        y = relu(self.child(BatchNorm, f, momentum=0.9)(y))
        y = self.child(Conv, f, f * 4, 1, dtype=d)(y)
        return shortcut + y


class ResNet50V2(_Net):
    """ResNet50 v2 (pre-activation) + GAP head."""

    def forward(self, x):
        x = scale_input(x, self.dtype)
        x = self.conv(x, 64, 7, strides=2)
        x = max_pool(x, 3, 2, ((1, 1), (1, 1)))
        for f, n, s in ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)):
            for i in range(n):
                x = self.child(_BottleneckV2, f, s if i == 0 else 1,
                               self.dtype)(x)
        x = relu(self.bn(x))
        return self.head(x.mean(dim=(2, 3)))


def _vgg19(num_classes, dtype=torch.bfloat16):
    return VGG(num_classes=num_classes, blocks=(2, 2, 4, 4, 4), dtype=dtype)


def _mnv3_large(num_classes, dtype=torch.bfloat16):
    from .backbones import MobileNetV3

    return MobileNetV3(num_classes=num_classes, small=False, dtype=dtype)


def _lazy(name):
    def make(num_classes, dtype=torch.bfloat16):
        from . import backbones

        return getattr(backbones, name)(num_classes=num_classes,
                                        dtype=dtype)
    return make


# Keys are normalized (lowercase, separators stripped), so both the
# keras-era names ("efficientnetb0") and the current enum's names
# ("efficient_net_b0" / "efficientnet_b0",
# default_config.cpp:144-161) resolve. "current" follows the
# reference's alias (visual_identification_network.py:548 -> v119).
VERSIONS: dict[str, Callable[..., Compact]] = {
    "v1183": V118_3,
    "v118": V118_3,
    "v119": V119,
    "v200": V200,
    "v110": V110,
    "v100": V100,
    "current": V119,
    "vitb16": ViT,
    "vgg16": VGG,
    "vgg19": _vgg19,
    "resnet50v2": ResNet50V2,
    "resnet18": _lazy("ResNet18"),
    "efficientnetb0": _lazy("EfficientNetB0"),
    "mobilenetv3small": _lazy("MobileNetV3"),
    "mobilenetv3large": _mnv3_large,
    "convnextbase": _lazy("ConvNeXtBase"),
    "inceptionv3": _lazy("InceptionV3"),
    "xception": _lazy("Xception"),
    "nasnetmobile": _lazy("NASNetMobile"),
}


def _normalize(version: str) -> str:
    return str(version).lower().replace("_", "").replace("-", "")


def build(version: str, num_classes: int, dtype=None) -> Compact:
    """The network of `version` for `num_classes`, unmade (its children
    are made for an image shape by ``layers.materialize``); `dtype` is
    the compute type (default bfloat16)."""
    key = _normalize(version)
    if key not in VERSIONS:
        raise ValueError(
            f"unknown visual_identification_version {version!r}; "
            f"available: {sorted(VERSIONS)}")
    kwargs = {"num_classes": num_classes}
    if dtype is not None:
        kwargs["dtype"] = dtype
    return VERSIONS[key](**kwargs)
