"""Layers that compute what flax/linen's compute, for the network zoo.

The JAX package writes its networks as flax ``@nn.compact`` modules:
children are made at the first call, from the input's shape, and named
by class and order (``Conv_0``, ``BatchNorm_1``, ``ConvBlock_0``). The
port's :class:`Compact` does the same on torch modules, so its module
tree has the flax variables' names and ``vi_params.py`` maps the two by
path. A network is built by one call on a ``meta`` tensor of the input's
shape (:func:`materialize`), which makes every child without computing.

Tensors are NCHW; flax's are NHWC. The dtype policy is flax's: a layer
with ``dtype`` bfloat16 casts its input and its float32 parameters to
bfloat16 and computes there, and adds its bias after the product's
rounding (flax's ``y += bias`` in the compute type). ``BatchNorm`` and
``LayerNorm`` compute in (at least) float32 with flax's formulas; LayerNorm's
epsilon is flax's 1e-6. ``SAME`` padding is XLA's, asymmetric where the
total is odd (stride 2).

A network runs in train mode when it is called with ``train=True``
(flax's ``train`` argument): :class:`Compact` hands the flag to every
child it makes, ``BatchNorm`` then normalizes with the batch's
statistics and updates its running ones, and ``Dropout`` drops with the
generator passed as ``rng`` (flax's ``rngs={"dropout": ...}``).

Data parallel (:func:`data_parallel`): a network whose ranks each see a
slice of the batch computes what flax computes on the whole batch under
JAX's sharded ``jit``. Train-mode ``BatchNorm`` takes its statistics
over the global batch (the ranks' sums all-reduced) and ``Dropout``
draws the global batch's mask from the generator, identical on every
rank, and keeps its rank's rows.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

Pair = Union[int, Sequence[int]]


def _pair(v: Pair) -> tuple:
    return (int(v), int(v)) if isinstance(v, int) else tuple(int(a) for a in v)


def same_pads(size: int, k: int, s: int) -> tuple:
    """XLA's SAME padding of one spatial dimension: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_hw(x, padding, k, s):
    """``padding`` ("SAME", "VALID" or ((top, bottom), (left, right)))
    applied to an NCHW tensor with zeros."""
    if padding == "VALID":
        return x
    if padding == "SAME":
        (t, b), (l, r) = (same_pads(x.shape[2], k[0], s[0]),
                          same_pads(x.shape[3], k[1], s[1]))
    else:
        (t, b), (l, r) = padding
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b))
    return x


class Compact(nn.Module):
    """A module whose children are made at its first call and named as
    flax names them: class name and the count of that class's children
    made before it in the same call. ``train`` and ``rng`` of the call
    reach every child that takes them (``Compact``, ``BatchNorm``,
    ``Dropout``)."""

    def __init__(self):
        super().__init__()
        self._seen: dict = {}
        self._inits: dict = {}  # raw parameter -> initializer tag
        self._train = False
        self._rng: Optional[torch.Generator] = None

    def __call__(self, *args, train: bool = False,
                 rng: Optional[torch.Generator] = None, **kwargs):
        self._seen = {}
        self._train, self._rng = bool(train), rng
        return super().__call__(*args, **kwargs)

    def child(self, cls, *args, **kwargs):
        """The child of `cls` made at this position (made now, from the
        arguments, at the first call), called with this call's mode."""
        name = cls.__name__
        i = self._seen.get(name, 0)
        self._seen[name] = i + 1
        key = f"{name}_{i}"
        mod = self._modules.get(key)
        if mod is None:
            mod = cls(*args, **kwargs)
            self.add_module(key, mod)
        if isinstance(mod, (Compact, Dropout)):
            return functools.partial(mod, train=self._train, rng=self._rng)
        if isinstance(mod, BatchNorm):
            return functools.partial(mod, train=self._train)
        return mod

    def param(self, name: str, shape, init: str) -> torch.Tensor:
        """A raw parameter (flax's ``self.param``), with its initializer's
        name: ``normal0.02`` or ``const1e-6``."""
        p = self._parameters.get(name)
        if p is None:
            p = nn.Parameter(torch.empty(tuple(shape)))
            self._inits[name] = init
            self.register_parameter(name, p)
        return p


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW: weight OIHW, bias added after the
    product's rounding to ``dtype``."""

    def __init__(self, in_features: int, features: int, kernel_size: Pair,
                 strides: Pair = 1, padding="SAME", groups: int = 1,
                 use_bias: bool = True, dtype=torch.bfloat16):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features // groups, *self.kernel_size))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias \
            else None

    def forward(self, x):
        x = _pad_hw(x.to(self.dtype), self.padding, self.kernel_size,
                    self.strides)
        y = F.conv2d(x, self.weight.to(self.dtype), None, self.strides,
                     0, 1, self.groups)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)
        return y


class Dense(nn.Module):
    """flax ``nn.Dense`` on the last axis: weight (out, in). ``chw`` is
    the (C, H, W) feature map an NCHW flatten made its input from (flax
    flattens (H, W, C)); ``vi_params.py`` reorders the kernel by it."""

    def __init__(self, in_features: int, features: int,
                 dtype=torch.bfloat16, chw: Optional[tuple] = None):
        super().__init__()
        self.dtype = dtype
        self.chw = chw
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y + self.bias.to(self.dtype)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over axis 1, in float32: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``. With ``train`` False the
    running statistics are read (``use_running_average=True``); with
    ``train`` True the batch's mean and biased variance ``max(0, E[x^2]
    - E[x]^2)`` (flax's fast variance) are used, gradients flow through
    them, and the running statistics become ``momentum * running + (1 -
    momentum) * batch`` with that same biased variance. flax's momentum
    weighs the old value (its default 0.99); ``torch.nn.BatchNorm2d``'s
    weighs the new one and updates with the unbiased variance, so it
    does not serve."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 momentum: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.momentum = momentum
        self.dp = None  # the data-parallel group (data_parallel)
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.empty(features))
        self.register_buffer("var", torch.empty(features))

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            axes = [0] + list(range(2, x.dim()))
            if self.dp is None:
                mean = x.mean(axes)
                meansq = (x * x).mean(axes)
            else:
                mean, meansq = _global_moments(x, axes, self.dp)
            var = torch.clamp(meansq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (x - mean.reshape(shape)) * mul.reshape(shape)
        return y + self.bias.reshape(shape)


def _global_moments(x, axes, dp):
    """E[x] and E[x^2] over the global batch: each rank's sums of x and
    x*x and its element count, all-reduced (SUM) in one autograd-aware
    collective, so gradients flow through the global statistics."""
    from ..parallel.distributed import all_reduce_sum

    c = x.shape[1]
    n = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
    sums = all_reduce_sum(torch.cat([x.sum(axes), (x * x).sum(axes), n]),
                          dp.group)
    return sums[:c] / sums[2 * c], sums[c:2 * c] / sums[2 * c]


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode each value is kept with
    probability ``1 - rate`` and divided by ``1 - rate`` (in its own
    type), else zeroed; the mask is ``torch.rand(..., generator=rng) <
    1 - rate``, drawn from the generator the caller passes (flax's
    ``dropout`` stream; ``F.dropout`` takes none). Identity outside
    train mode and at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.dp = None  # the data-parallel group (data_parallel)

    def forward(self, x, train: bool = False,
                rng: Optional[torch.Generator] = None):
        if not train or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if rng is None:
            raise ValueError("train-mode dropout needs a generator (rng)")
        keep = 1.0 - self.rate
        if self.dp is None:
            mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
        else:
            b = x.shape[0]
            mask = torch.rand((b * self.dp.size,) + tuple(x.shape[1:]),
                              generator=rng, device=x.device)[
                self.dp.rank * b:(self.dp.rank + 1) * b] < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def data_parallel(model: nn.Module, dp) -> nn.Module:
    """Make `model`'s train mode data parallel over `dp` (an object with
    the process ``group``, this rank's ``rank`` and the group's
    ``size``; None makes it single-device again): every ``BatchNorm``
    takes global batch statistics, every ``Dropout`` the global batch's
    mask. Each rank's slice of the batch is rows ``[rank * b, (rank + 1)
    * b)`` of the global batch."""
    for m in model.modules():
        if isinstance(m, (BatchNorm, Dropout)):
            m.dp = dp
    return model


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis, in float32, with its
    single-pass variance ``max(0, E[x^2] - E[x]^2)`` and epsilon 1e-6."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return (x - mu) * mul + self.bias


class DenseGeneral(nn.Module):
    """The projections of flax's attention, kept in flax's layout:
    ``kernel`` (in, heads, head_dim) into heads, or (heads, head_dim,
    out) out of them, with ``bias`` of the output's shape."""

    def __init__(self, features: int, num_heads: int, into_heads: bool,
                 dtype=torch.bfloat16):
        super().__init__()
        hd = features // num_heads
        self.dtype = dtype
        self.into_heads = into_heads
        if into_heads:
            self.kernel = nn.Parameter(torch.empty(features, num_heads, hd))
            self.bias = nn.Parameter(torch.empty(num_heads, hd))
        else:
            self.kernel = nn.Parameter(torch.empty(num_heads, hd, features))
            self.bias = nn.Parameter(torch.empty(features))

    def forward(self, x):
        k = self.kernel.to(self.dtype)
        eq = "bnd,dhk->bnhk" if self.into_heads else "bnhk,hkd->bnd"
        return torch.einsum(eq, x.to(self.dtype), k) \
            + self.bias.to(self.dtype)


class MultiHeadDotProductAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (self-attention, no mask,
    no dropout): query scaled by 1/sqrt(head_dim) in the compute type,
    softmax in the compute type."""

    def __init__(self, features: int, num_heads: int,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        for name in ("query", "key", "value"):
            self.add_module(name, DenseGeneral(features, num_heads, True,
                                               dtype))
        self.out = DenseGeneral(features, num_heads, False, dtype)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(w, dim=-1).to(self.dtype)
        y = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(y)


def max_pool(x, k: Pair, s: Pair, padding=((0, 0), (0, 0))):
    """flax ``nn.max_pool``; padding reads -inf."""
    (t, b), (l, r) = padding
    if (t, l) == (b, r):
        return F.max_pool2d(x, _pair(k), _pair(s), (t, l))
    x = F.pad(x, (l, r, t, b), value=-math.inf)
    return F.max_pool2d(x, _pair(k), _pair(s))


def avg_pool(x, k: Pair, s: Pair, padding="VALID"):
    """flax ``nn.avg_pool`` (padding counts: the window's sum over its
    full size)."""
    k, s = _pair(k), _pair(s)
    x = _pad_hw(x, padding, k, s)
    return F.avg_pool2d(x, k, s)


def flatten(x):
    """NCHW -> (N, C*H*W) and the (C, H, W) it came from."""
    return x.reshape(x.shape[0], -1), tuple(x.shape[1:])


def gelu(x):
    """flax ``nn.gelu`` (the tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def _lecun_normal(t, fan_in, generator):
    """flax's variance_scaling(1, fan_in, truncated_normal): a normal
    truncated at +-2 std, corrected to std 1/sqrt(fan_in), drawn by the
    inverse CDF."""
    std = math.sqrt(1.0 / max(1, fan_in)) / .87962566103423978
    lo = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0
    t.uniform_(2 * lo - 1, 1 - 2 * lo, generator=generator)
    t.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator):
    """flax's default initializers, drawn from `generator` in module
    order: lecun-normal kernels, zero biases, unit scales and variances,
    zero means; raw parameters by their ``init`` tag."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense)):
            w = mod.weight
            _lecun_normal(w, w[0].numel(), generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, DenseGeneral):
            k = mod.kernel
            fan_in = k.shape[0] if mod.into_heads \
                else k.shape[0] * k.shape[1]
            _lecun_normal(k, fan_in, generator)
            mod.bias.zero_()
        elif isinstance(mod, (BatchNorm, LayerNorm)):
            mod.scale.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.mean.zero_()
                mod.var.fill_(1.0)
        for name, tag in getattr(mod, "_inits", {}).items():
            p = mod._parameters[name]
            if tag == "normal0.02":
                nn.init.normal_(p, 0.0, 0.02, generator=generator)
            elif tag == "const1e-6":
                p.fill_(1e-6)


def materialize(model: nn.Module, image_shape, generator=None,
                device=None) -> nn.Module:
    """Make every child of `model` for (H, W, C) inputs (one call on a
    ``meta`` tensor), initialize the parameters on the CPU from
    `generator` (seed 0 when None) and move the model to `device`, in
    evaluation mode."""
    h, w, c = (int(v) for v in image_shape)
    with torch.device("meta"):
        model(torch.zeros(1, c, h, w))
    model.to_empty(device="cpu")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(device or "cpu").eval()
