"""Physical-tag payload decoding (the `pretrained_tagwork` backend).

Counterpart of ``trex_tpu/ml/tagwork.py``. The reference
(Application/pretrained_tagwork.py + the RecTask backend in
python/PythonBackendRegistry.cpp:18-49) loads a user-supplied keras
``.h5`` model from `tags_model_path`, feeds it inverted tag crops
(``255 - image``) and returns ``argmax(predict(images))`` as int64 tag
ids.

- :func:`load_keras_sequential_h5` reads a legacy keras Sequential
  ``.h5`` file with the port's own HDF5 reader (``io/hdf5.py``) and
  builds :class:`KerasSequential`, a torch module on the resolved
  device. The layer set is the reference's import list
  (pretrained_tagwork.py:3-5).
- :class:`Tagwork` mirrors the reference class; the decoder of
  :func:`tag_decoder_from_settings` decodes one crop or, through its
  ``batch`` form, a frame's crops in one forward.
- :class:`TagDecoderNet` (3x conv-relu-pool + dense) and
  :func:`train_tag_decoder` train a decoder on labelled crops (the
  JAX package's initialisation and permutation from the seed, the
  port's optax-equivalent Adam); :func:`save_keras_sequential_h5`
  writes it back as a reference-compatible ``.h5``.

The network computes in NCHW; keras's NHWC semantics are kept where they
show: ``Flatten`` and a ``Dense`` on a 4-D tensor permute to NHWC first,
a ``softmax`` after a convolution acts on the channels, ``same`` padding
and pooling pad like TF (the extra row and column at the bottom and
right, ``-inf`` for the pool).
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..io import hdf5
from ..track.tag_image import resize_area

_SUPPORTED = {
    "InputLayer", "Conv2D", "Dense", "MaxPooling2D", "BatchNormalization",
    "Flatten", "Activation", "Dropout", "SpatialDropout2D", "Cropping2D",
}


@dataclass
class _Layer:
    kind: str
    cfg: dict
    weights: list  # numpy arrays in keras order


def _layer_configs(model_config: dict) -> list[dict]:
    cfg = model_config
    if cfg.get("class_name") not in (None, "Sequential"):
        raise ValueError(
            f"only Sequential keras models are supported, "
            f"got {cfg.get('class_name')!r}")
    inner = cfg.get("config", cfg)
    layers = inner["layers"] if isinstance(inner, dict) else inner
    return layers


def _read_weights(h5, layer_name: str) -> list[np.ndarray]:
    mw = h5["model_weights"] if "model_weights" in h5 else h5
    if layer_name not in mw:
        return []
    grp = mw[layer_name]
    names = grp.attrs.get("weight_names", [])
    out = []
    for n in names:
        if isinstance(n, bytes):
            n = n.decode()
        out.append(np.array(grp[n]))
    return out


def _activation(name: Optional[str]):
    """The keras activation on NCHW (4-D: keras's last axis is dim 1)
    or (N, C) tensors."""
    if name in (None, "linear"):
        return lambda x: x
    if name == "relu":
        return torch.relu
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=1 if x.dim() == 4 else -1)
    if name == "sigmoid":
        return torch.sigmoid
    if name == "tanh":
        return torch.tanh
    raise ValueError(f"unsupported activation {name!r}")


def _same_pads(size: int, k: int, s: int) -> tuple:
    """TF/lax ``SAME``: (before, after), the extra one after."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad2d(x, kernel, strides, value=0.0):
    pt, pb = _same_pads(x.shape[2], kernel[0], strides[0])
    pl, pr = _same_pads(x.shape[3], kernel[1], strides[1])
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=value)
    return x


def _conv_same(x, kernel, bias, strides):
    """A ``same`` convolution: symmetric pads go to the convolution
    itself, asymmetric ones (TF's extra row and column) through F.pad."""
    k = tuple(kernel.shape[2:])
    pt, pb = _same_pads(x.shape[2], k[0], strides[0])
    pl, pr = _same_pads(x.shape[3], k[1], strides[1])
    if pt == pb and pl == pr:
        return F.conv2d(x, kernel, bias, stride=strides, padding=(pt, pl))
    return F.conv2d(F.pad(x, (pl, pr, pt, pb)), kernel, bias,
                    stride=strides)


def _nhwc_last(x, fn):
    """Apply `fn` on keras's last axis of an NCHW tensor."""
    return fn(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class KerasSequential(torch.nn.Module):
    """A keras Sequential .h5 model executed with torch on `device`."""

    def __init__(self, layers: list[_Layer], device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.layers = layers
        self._steps = []
        for i, ly in enumerate(layers):
            step = self._build(ly, i)
            if step is not None:
                self._steps.append(step)

    def _t(self, name: str, arr) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(arr, np.float32), device=self.device)
        self.register_buffer(name, t)
        return t

    def _build(self, ly: _Layer, i: int):
        kind, cfg, w = ly.kind, ly.cfg, ly.weights
        if kind in ("InputLayer", "Dropout", "SpatialDropout2D"):
            return None
        if kind == "Conv2D":
            dil = tuple(cfg.get("dilation_rate", (1, 1)))
            if dil != (1, 1) or int(cfg.get("groups", 1)) != 1:
                raise ValueError(
                    f"unsupported Conv2D options: dilation_rate={dil}, "
                    f"groups={cfg.get('groups', 1)}")
            kernel = self._t(f"l{i}_kernel",
                             np.transpose(np.asarray(w[0]), (3, 2, 0, 1)))
            bias = self._t(f"l{i}_bias", w[1]) \
                if cfg.get("use_bias", True) else None
            strides = tuple(int(s) for s in cfg.get("strides", (1, 1)))
            same = cfg.get("padding", "valid").lower() == "same"
            act = _activation(cfg.get("activation"))

            def conv(x):
                if same:
                    return act(_conv_same(x, kernel, bias, strides))
                return act(F.conv2d(x, kernel, bias, stride=strides))
            return conv
        if kind == "Dense":
            W = self._t(f"l{i}_kernel", w[0])
            b = self._t(f"l{i}_bias", w[1]) \
                if cfg.get("use_bias", True) else None
            act = _activation(cfg.get("activation"))

            def lin(x):
                y = torch.matmul(x, W)
                return y if b is None else y + b

            def dense(x):
                return act(_nhwc_last(x, lin) if x.dim() == 4 else lin(x))
            return dense
        if kind == "MaxPooling2D":
            pool = tuple(int(p) for p in cfg.get("pool_size", (2, 2)))
            strides = tuple(int(s) for s in (cfg.get("strides") or pool))
            same = cfg.get("padding", "valid").lower() == "same"

            def mpool(x):
                if same:
                    x = _pad2d(x, pool, strides, value=-math.inf)
                return F.max_pool2d(x, pool, strides)
            return mpool
        if kind == "BatchNormalization":
            # keras order: gamma, beta, moving_mean, moving_variance
            # (scale/center flags drop gamma/beta from the list)
            k = 0
            gamma = beta = None
            if cfg.get("scale", True):
                gamma = self._t(f"l{i}_gamma", w[k])
                k += 1
            if cfg.get("center", True):
                beta = self._t(f"l{i}_beta", w[k])
                k += 1
            mean = self._t(f"l{i}_mean", w[k])
            var = self._t(f"l{i}_var", w[k + 1])
            eps = float(cfg.get("epsilon", 1e-3))

            def bn_last(x):
                y = (x - mean) / torch.sqrt(var + eps)
                if gamma is not None:
                    y = y * gamma
                if beta is not None:
                    y = y + beta
                return y

            def bn(x):
                return _nhwc_last(x, bn_last) if x.dim() == 4 else bn_last(x)
            return bn
        if kind == "Flatten":
            def flatten(x):
                if x.dim() == 4:
                    x = x.permute(0, 2, 3, 1)
                return x.reshape(x.shape[0], -1)
            return flatten
        if kind == "Activation":
            return _activation(cfg.get("activation"))
        if kind == "Cropping2D":
            ((t, b), (l, r)) = cfg.get("cropping", ((0, 0), (0, 0)))

            def crop(x):
                return x[:, :, t:x.shape[2] - b or None,
                         l:x.shape[3] - r or None]
            return crop
        raise ValueError(f"unsupported keras layer {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) float32 -> the model's output (NHWC if 4-D)."""
        if x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        for f in self._steps:
            x = f(x)
        if x.dim() == 4:
            x = x.permute(0, 2, 3, 1)
        return x

    @torch.inference_mode()
    def predict(self, images) -> np.ndarray:
        x = np.asarray(images, np.float32)
        if x.ndim == 3:
            x = x[..., None]
        t = torch.as_tensor(x, device=self.device)
        return self(t).float().cpu().numpy()


def load_keras_sequential_h5(path, device=None) -> KerasSequential:
    with hdf5.File(path) as f:
        raw = f.attrs.get("model_config")
        if raw is None:
            raise ValueError(f"{path}: no model_config attribute "
                             "(not a keras .h5 model)")
        if isinstance(raw, bytes):
            raw = raw.decode()
        cfg = json.loads(raw)
        layers = []
        for lcfg in _layer_configs(cfg):
            kind = lcfg["class_name"]
            if kind not in _SUPPORTED:
                raise ValueError(f"unsupported keras layer {kind!r}")
            name = lcfg["config"].get("name", kind.lower())
            layers.append(_Layer(kind=kind, cfg=lcfg["config"],
                                 weights=_read_weights(f, name)))
    return KerasSequential(layers, device=device)


def save_keras_sequential_h5(path, layer_specs: list[tuple]) -> None:
    """Write a legacy keras Sequential .h5 that both
    :func:`load_keras_sequential_h5`, the JAX package's reader and the
    reference's ``keras.models.load_model`` accept.

    layer_specs: list of (class_name, config_dict, [weight arrays])."""
    layers_json = []
    for kind, cfg, _w in layer_specs:
        layers_json.append({"class_name": kind, "config": cfg})
    model_config = {"class_name": "Sequential",
                    "config": {"name": "sequential", "layers": layers_json}}
    with hdf5.writer(path) as f:
        f.attrs["model_config"] = json.dumps(model_config)
        mw = f.create_group("model_weights")
        names = []
        for kind, cfg, w in layer_specs:
            name = cfg.get("name", kind.lower())
            names.append(name.encode())
            grp = mw.create_group(name)
            wnames = []
            suffixes = _weight_suffixes(kind, cfg, len(w))
            for arr, suf in zip(w, suffixes):
                p = f"{name}/{suf}"
                wnames.append(p.encode())
                grp.create_dataset(p, data=np.asarray(arr))
            grp.attrs["weight_names"] = wnames
        mw.attrs["layer_names"] = names


def _weight_suffixes(kind: str, cfg: dict, n: int) -> list[str]:
    if kind in ("Conv2D", "Dense"):
        return ["kernel:0", "bias:0"][:n]
    if kind == "BatchNormalization":
        out = []
        if cfg.get("scale", True):
            out.append("gamma:0")
        if cfg.get("center", True):
            out.append("beta:0")
        out += ["moving_mean:0", "moving_variance:0"]
        return out[:n]
    return []


# --------------------------------------------------------------------------
# the reference protocol (pretrained_tagwork.Tagwork)
# --------------------------------------------------------------------------

class Tagwork:
    """pretrained_tagwork.py:17-37 — width/height, load(), predict()
    with the 255-x inversion and argmax over class logits."""

    def __init__(self, width: int, height: int, model_path, device=None):
        self.width = int(width)
        self.height = int(height)
        self.model_path = model_path
        self.device = device
        self.model: Optional[KerasSequential] = None

    def load(self, path=None):
        self.model = load_keras_sequential_h5(path or self.model_path,
                                              device=self.device)

    def predict(self, images) -> np.ndarray:
        assert self.model is not None
        x = 255.0 - np.asarray(images, np.float64)
        y = np.argmax(self.model.predict(x), axis=-1)
        return y.astype(np.int64)


def _confidences(out: np.ndarray) -> tuple:
    """(ids, ps) of the output rows: a row's p is its max probability
    when it already sums to 1, else its max softmax."""
    idx = np.argmax(out, axis=1)
    top = out[np.arange(len(out)), idx]
    probs = (out.min(axis=1) >= 0.0) & (np.abs(out.sum(axis=1) - 1.0) < 1e-3)
    with np.errstate(over="ignore", invalid="ignore"):
        e = np.exp(out - top[:, None])
        soft = 1.0 / np.sum(e, axis=1)
    soft = np.where(np.isfinite(e).all(axis=1), soft, 1.0)
    return idx.astype(np.int64), np.where(probs, top, soft)


class TagDecoder:
    """The decode_fn of ``track/tags.py``: ``decoder.batch(images)``
    gives the ids and ps of many crops in one forward, ``decoder(image)``
    one crop's ``(id, p)`` through the same call. Crops of another size
    are resized with OpenCV's area rule (``tag_image.resize_area``)."""

    def __init__(self, tagwork: Tagwork):
        self.tw = tagwork
        self.calls = 0
        self.images = 0

    def _prepare(self, image) -> np.ndarray:
        img = np.asarray(image, np.uint8)
        if img.shape[:2] != (self.tw.height, self.tw.width):
            img = resize_area(img, (self.tw.width, self.tw.height))
        return img

    @torch.inference_mode()
    def _forward(self, imgs: np.ndarray) -> np.ndarray:
        """The model's output on ``255 - imgs``: the uint8 crops go to
        the device as they are and are inverted there in float32, which
        holds the float64 inversion's integers exactly."""
        self.calls += 1
        self.images += len(imgs)
        model = self.tw.model
        x = torch.as_tensor(np.ascontiguousarray(imgs), device=model.device)
        x = (255.0 - x.to(torch.float32))[..., None]
        return model(x).float().cpu().numpy()

    def __call__(self, image) -> tuple:
        ids, ps = self.batch([image])
        return int(ids[0]), float(ps[0])

    def batch(self, images) -> tuple:
        if not len(images):
            return np.zeros(0, np.int64), np.zeros(0, np.float64)
        out = np.asarray(self._forward(
            np.stack([self._prepare(i) for i in images])), np.float64)
        return _confidences(out)


def tag_decoder_from_settings(settings, device=None
                              ) -> Optional[TagDecoder]:
    """The decoder for track/tags.py when `tags_model_path` points at a
    readable model, its network on `device`; None otherwise (the tracker
    keeps running with undecoded tag ids)."""
    path = settings["tags_model_path"]
    if not path or not os.path.exists(path):
        return None
    size = settings["tags_image_size"] or [32, 32]
    tw = Tagwork(int(size[0]), int(size[1]), path, device=device)
    tw.load()
    return TagDecoder(tw)


# --------------------------------------------------------------------------
# in-framework decoder training
# --------------------------------------------------------------------------

class TagDecoderNet(torch.nn.Module):
    """Small CNN for square tag crops: 3x(conv-relu-pool) + dense.

    Kept keras-exportable: the layer stack maps 1:1 onto the Sequential
    .h5 layout. The parameters start from the JAX package's numpy
    initialisation for the same seed; :meth:`from_params` and
    :meth:`to_params` carry its ``params`` dict (HWIO kernels, (in, out)
    dense) in and out."""

    def __init__(self, n_classes: int, size: int = 32, seed: int = 0,
                 device=None):
        super().__init__()
        self.size = size
        self.n_classes = n_classes
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)

        def conv_init(k, cin, cout):
            fan_in = k * k * cin
            lim = np.sqrt(6.0 / fan_in)
            return (rng.uniform(-lim, lim, (k, k, cin, cout))
                    .astype(np.float32))

        s = size // 8
        params = {
            "c1": [conv_init(3, 1, 16), np.zeros(16, np.float32)],
            "c2": [conv_init(3, 16, 32), np.zeros(32, np.float32)],
            "c3": [conv_init(3, 32, 64), np.zeros(64, np.float32)],
            "d1": [
                (rng.uniform(-0.05, 0.05, (s * s * 64, n_classes))
                 .astype(np.float32)),
                np.zeros(n_classes, np.float32),
            ],
        }
        self.weights = torch.nn.ParameterDict()
        self.load_params(params)

    def load_params(self, params: dict) -> None:
        """Take the JAX package's ``params`` layout."""
        for key in ("c1", "c2", "c3"):
            k, b = params[key]
            self.weights[f"{key}_w"] = self._p(
                np.transpose(np.asarray(k), (3, 2, 0, 1)))
            self.weights[f"{key}_b"] = self._p(b)
        self.weights["d1_w"] = self._p(params["d1"][0])
        self.weights["d1_b"] = self._p(params["d1"][1])

    def _p(self, arr) -> torch.nn.Parameter:
        return torch.nn.Parameter(torch.as_tensor(
            np.ascontiguousarray(arr, np.float32), device=self.device))

    @classmethod
    def from_params(cls, params: dict, device=None) -> "TagDecoderNet":
        """A module with the JAX package's ``TagDecoderNet.params``."""
        n_classes = int(np.asarray(params["d1"][1]).shape[0])
        flat = int(np.asarray(params["d1"][0]).shape[0])
        size = 8 * int(round(math.sqrt(flat // 64)))
        net = cls(n_classes, size=size, device=device)
        net.load_params(params)
        return net

    def to_params(self) -> dict:
        """The parameters in the JAX package's layout, as numpy."""
        w = {k: v.detach().float().cpu().numpy()
             for k, v in self.weights.items()}
        out = {key: [np.transpose(w[f"{key}_w"], (2, 3, 1, 0)).copy(),
                     w[f"{key}_b"]] for key in ("c1", "c2", "c3")}
        out["d1"] = [w["d1_w"], w["d1_b"]]
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 1) inverted crops -> (N, n_classes) logits."""
        x = x.permute(0, 3, 1, 2)
        for key in ("c1", "c2", "c3"):
            x = F.conv2d(x, self.weights[f"{key}_w"], self.weights[f"{key}_b"],
                         padding=1)
            x = F.max_pool2d(torch.relu(x), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return torch.matmul(x, self.weights["d1_w"]) + self.weights["d1_b"]

    def layer_specs(self) -> list[tuple]:
        """Export as keras Sequential layer specs (save_keras_sequential_h5)."""
        p = self.to_params()
        specs = []
        for i, key in enumerate(("c1", "c2", "c3")):
            specs.append(("Conv2D", {
                "name": f"conv2d_{i}", "activation": "relu",
                "padding": "same", "strides": [1, 1], "use_bias": True,
            }, [p[key][0], p[key][1]]))
            specs.append(("MaxPooling2D", {
                "name": f"max_pooling2d_{i}", "pool_size": [2, 2],
                "padding": "valid",
            }, []))
        specs.append(("Flatten", {"name": "flatten"}, []))
        specs.append(("Dense", {
            "name": "dense", "activation": "linear", "use_bias": True,
        }, [p["d1"][0], p["d1"][1]]))
        return specs


def tag_train_step(net: TagDecoderNet, opt):
    """One Adam step on a batch: the mean softmax cross-entropy of the
    integer labels (optax's), its gradients and the update. Returns the
    loss as a device scalar."""
    def step(xb, yb):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(net(xb), yb)
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def train_tag_decoder(images: np.ndarray, labels: np.ndarray,
                      n_classes: int, epochs: int = 20,
                      batch_size: int = 128, lr: float = 1e-3,
                      seed: int = 0, device=None) -> TagDecoderNet:
    """Train TagDecoderNet on (N, H, W) uint8 crops with int labels, on
    `device`. Raw (un-inverted) crops go in; the inversion happens here
    and at predict time inside Tagwork."""
    from ..models.training import adam

    dev = resolve_device(device)
    net = TagDecoderNet(n_classes, size=images.shape[1], seed=seed,
                        device=dev)
    x = torch.as_tensor((255.0 - np.asarray(images, np.float32))[..., None],
                        device=dev)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    opt = adam(net.parameters(), lr)
    step = tag_train_step(net, opt)
    rng = np.random.default_rng(seed)
    n = len(x)
    for _ in range(epochs):
        order = rng.permutation(n)
        for s in range(0, n, batch_size):
            sel = torch.as_tensor(order[s:s + batch_size], device=dev)
            step(x[sel], y[sel])
    return net
