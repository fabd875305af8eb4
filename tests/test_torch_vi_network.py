"""The port's VI network zoo (trex_tpu_torch/models/) against the JAX
package's flax modules with the same variables.

Every `build` version: the flax model's variables (its own initializer,
then batch statistics, scales and biases redrawn from a numpy seed) go
through the flat npz layout into the port's module by
`vi_params.from_flax_arrays`, and both compute logits of the same
uint8-valued images. Tolerances, relative to the largest logit:

- float32 (`dtype=float32` on both): 1e-5. Both compute the same
  operations in float32; sums and convolutions are taken in another
  order (XLA against oneDNN). Measured: at most 1.6e-6 (ConvNeXtBase).
- bfloat16 (the default policy): 0.05, and softmax rows within
  ROW_TOL (0.02). Both round activations to
  bfloat16 (8 bits) after every convolution and hidden dense layer, but
  XLA's CPU backend keeps fused elementwise chains in float32 where
  torch rounds after each operation, so single activations differ by a
  bfloat16 ulp or two, and deep stacks carry that further. Measured:
  at most 0.015 (ConvNeXtBase), 0.008 for the default v118_3.

Also: the npz round trip JAX -> port -> JAX keeps every array's bytes,
and `load_torch_vi_weights` gives the JAX importer's arrays."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trex_tpu.models import vi_network as jax_vi
from trex_tpu.models.training import VITrainer as JaxTrainer
from trex_tpu.models.vi_convert import \
    load_torch_vi_weights as jax_load_torch
from trex_tpu_torch.models import layers, vi_network, vi_params
from trex_tpu_torch.models.training import VITrainer
from trex_tpu_torch.models.vi_convert import (flatten_variables,
                                              load_torch_vi_weights)

F32_TOL = 1e-5
BF16_TOL = 0.05
# softmax rows of the bfloat16 policy: one bfloat16 ulp (2^-9 relative)
# on the activations moves a logit of a few units by a few 1e-2, and a
# softmax row by at most half the largest logit change
ROW_TOL = 0.02

# version -> the input edge it is compared at (the flatten heads at the
# crops' 80x80, the deep global-pool backbones smaller to stay quick)
VERSIONS = {
    "v118_3": 80, "v110": 80, "v100": 80, "v119": 64, "v200": 36,
    "vitb16": 40, "vgg16": 32, "vgg19": 32, "resnet50v2": 32,
    "resnet18": 32, "efficientnet_b0": 32, "mobilenet_v3_small": 48,
    "mobilenet_v3_large": 48, "inception_v3": 64, "xception": 32,
    "nasnetmobile": 48, "convnext_base": 32,
}


def _flat(variables) -> dict:
    """The JAX package's save_weights keys and arrays."""
    flat = jax.tree_util.tree_flatten_with_path(
        {"params": variables["params"],
         "batch_stats": variables.get("batch_stats", {})})[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): a
            for path, a in flat}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, a in flat.items():
        *path, leaf = key.split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = jnp.asarray(a)
    return out


def _variables(model, edge, seed):
    """Every array of the flax model's variables drawn from `seed`:
    kernels lecun-normal by their fan-in, biases, scales, statistics and
    raw parameters around their usual values, so that every array
    matters."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, edge, edge, 1)), train=False))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, a in _flat(shapes).items():
        path, leaf = k.rsplit("/", 1)
        shape = a.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:2])) if len(shape) == 3 \
                and path.endswith("/out") else int(np.prod(shape[:-1])) \
                if len(shape) != 3 else shape[0]
            v = rng.normal(0, 1 / np.sqrt(fan_in), shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif leaf == "mean":
            v = rng.normal(0, 0.2, shape)
        elif leaf == "scale":
            v = rng.uniform(0.8, 1.2, shape)
        elif leaf == "bias":
            v = rng.normal(0, 0.05, shape)
        elif leaf == "layer_scale":
            v = rng.uniform(0.05, 0.2, shape)
        else:  # pos_embed
            v = rng.normal(0, 0.02, shape)
        flat[k] = v.astype(np.float32)
    return flat


def _port_model(version, edge, flat, dtype=None):
    m = layers.materialize(vi_network.build(version, 7, dtype=dtype),
                           (edge, edge, 1))
    return vi_params.from_flax_arrays(m, flat)


def _images(edge, n=3, seed=5):
    return np.random.default_rng(seed).integers(
        0, 256, (n, edge, edge, 1)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", sorted(VERSIONS))
def test_logits_equal_flax(version, dtype):
    edge = VERSIONS[version]
    jdt = jnp.float32 if dtype == "float32" else None
    tdt = torch.float32 if dtype == "float32" else None
    jm = jax_vi.build(version, 7, dtype=jdt)
    flat = _variables(jm, edge, seed=len(version))
    x = _images(edge)
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    want = np.asarray(apply(_nest(flat), jnp.asarray(x)), np.float32)
    pm = _port_model(version, edge, flat, tdt)
    assert set(vi_params.to_flax_arrays(pm)) == set(flat)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()
    assert got.shape == want.shape == (3, 7)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (version, dtype, err)


def test_default_dtype_policy():
    """bfloat16 convolutions and hidden dense layers, float32
    normalization and head, bfloat16 input scaling."""
    m = layers.materialize(vi_network.build("v118_3", 4), (80, 80, 1))
    dts = {type(mod).__name__: mod.dtype for mod in m.modules()
           if hasattr(mod, "dtype") and not isinstance(
               mod, vi_network._Net)}
    assert dts["Conv"] == torch.bfloat16
    assert m.Dense_0.dtype == torch.bfloat16
    assert m.Dense_1.dtype == torch.float32
    assert m.LayerNorm_0.epsilon == 1e-6
    assert m.ConvBlock_0.BatchNorm_0.epsilon == 1e-5
    x = torch.full((1, 1, 80, 80), 200.0)
    assert torch.equal(vi_network.scale_input(x, torch.bfloat16),
                       (x.to(torch.bfloat16) / 127.5) - 1.0)


def test_npz_round_trip_jax_port_jax(tmp_path):
    """A JAX VITrainer's weights file, loaded by the port and saved
    again, holds the same bytes in every array, and the JAX trainer
    loads it back."""
    jt = JaxTrainer(jax_vi.build("v118_3", 5), 5, (80, 80, 1), seed=3)
    a = tmp_path / "jax_weights.npz"
    jt.save_weights(a)
    pt = VITrainer(vi_network.build("v118_3", 5), 5, (80, 80, 1),
                   device="cpu")
    pt.load_weights(a)
    b = tmp_path / "port_weights.npz"
    pt.save_weights(b)
    with np.load(a) as za, np.load(b) as zb:
        assert list(za.files) == list(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape
            assert za[k].tobytes() == zb[k].tobytes(), k
        assert json.loads(str(zb["__meta__"][0])) == {
            "num_classes": 5, "image_shape": [80, 80, 1]}
    jt2 = JaxTrainer(jax_vi.build("v118_3", 5), 5, (80, 80, 1), seed=9)
    jt2.load_weights(b)
    x = _images(80, 4)
    np.testing.assert_array_equal(jt.predict(x), jt2.predict(x))


def test_predict_equals_jax_trainer(tmp_path):
    """predict's softmax rows, in batches with a padded tail, against the
    JAX trainer's on the same weights (bfloat16 policy: the rows within
    ROW_TOL)."""
    jt = JaxTrainer(jax_vi.build("v118_3", 6), 6, (80, 80, 1), seed=1)
    w = tmp_path / "w.npz"
    jt.save_weights(w)
    pt = VITrainer(vi_network.build("v118_3", 6), 6, (80, 80, 1),
                   device="cpu")
    pt.load_weights(w)
    x = _images(80, 11).astype(np.uint8)
    want = jt.predict(x, batch_size=4)
    got = pt.predict(x, batch_size=4)
    assert got.dtype == np.float32 and got.shape == (11, 6)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=ROW_TOL)
    np.testing.assert_array_equal(pt.predict(x[:0]), np.zeros((0, 6)))
    acc = pt.per_class_accuracy(x, got.argmax(1))
    assert acc.shape == (6,)


def test_load_torch_vi_weights_equals_jax_importer(tmp_path):
    """A TRex-layout V118_3 state dict (conv1..3, bn1..4, fc1, fc2) in a
    .pt file: the port's importer gives the JAX importer's arrays, and
    the port's network loads them."""
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))
    sd = {}
    for i, (ci, co) in enumerate(((1, 16), (16, 64), (64, 128))):
        sd[f"conv{i + 1}.weight"] = t(co, ci, 5, 5)
        sd[f"conv{i + 1}.bias"] = t(co)
        for k in ("weight", "bias", "running_mean"):
            sd[f"bn{i + 1}.{k}"] = t(co)
        sd[f"bn{i + 1}.running_var"] = t(co).abs() + 0.5
    sd["fc1.weight"], sd["fc1.bias"] = t(100, 128 * 10 * 10), t(100)
    sd["bn4.weight"], sd["bn4.bias"] = t(100), t(100)
    sd["fc2.weight"], sd["fc2.bias"] = t(9, 100), t(9)
    path = tmp_path / "trex_weights.pt"
    torch.save({"model." + k: v for k, v in sd.items()}, path)
    want = flatten_variables(jax_load_torch(path, "v118_3"))
    got = flatten_variables(load_torch_vi_weights(path, "v118_3"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    m = layers.materialize(vi_network.build("v118_3", 9), (80, 80, 1))
    vi_params.from_flax_arrays(m, got)
    # the torch layout comes back: conv and fc1 weights as TRex saved them
    assert torch.equal(m.ConvBlock_0.Conv_0.weight, sd["conv1.weight"])
    assert torch.equal(m.Dense_0.weight, sd["fc1.weight"])


def test_unknown_version_raises():
    with pytest.raises(ValueError, match="unknown"):
        vi_network.build("v999", 3)
    assert sorted(vi_network.VERSIONS) == sorted(jax_vi.VERSIONS)
