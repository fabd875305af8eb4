"""The training half of the port's visual identification
(trex_tpu_torch/models/: layers' train mode, training.py) against the
JAX package's flax modules, optax and VITrainer, on the CPU.

Dropout streams cannot agree across the two packages, so the twins
switch dropout off on both sides from here: ``flax.linen.Dropout`` is
built with rate 0 on the JAX side (no file of the JAX package changes)
and the port's ``Dropout`` modules get rate 0. Dropout itself is pinned
on its own (keep share and scaling), and its placement by the sequence
of rates each network's train-mode call applies.

Tolerances. Each array is compared relative to its largest absolute
value (at least 1), a gradient relative to the largest gradient of the
network; the measured gaps are for the inputs these tests draw.

- float32 (``dtype=float32`` on both): ``F32_TOL`` 1e-5, to the JAX
  package's values. Measured, port against JAX: logits, loss, batch
  statistics and gradients at most 6.7e-6, apart from the two versions
  that normalize a dense layer's 8 rows with a train-mode BatchNorm
  (v119, v200), which are ill-conditioned: its backward subtracts the
  batch's projections from the gradient and flax's fast variance ``E[x^2]
  - E[x]^2`` cancels digits. There a value beyond ``F32_TOL`` of JAX's is
  held to the JAX package's own float64 evaluation of the same step
  (flax's layers built with float64 compute and parameters under
  ``jax.enable_x64``): no further from it than ``RATIO`` (2) times the
  JAX package's float32 value. Measured: v119 gradients 1.10e-5 from
  JAX, 9.8e-6 and 5.3e-6 (port, JAX) from float64; v200 logits 1.11e-5
  from JAX, 8.3e-6 and 6.0e-6 from float64; v200 gradients 2.1e-2 from
  JAX, 1.8e-2 and 2.1e-2 from float64.
- bfloat16 (the default policy): the logits, the loss and the batch
  statistics within ``BF16_TOL`` 0.05 of JAX's, the bound tests/
  test_torch_vi_network.py states for the logits (measured at most
  4.6e-2, 3.5e-3 and 2.8e-3). Rounding to bfloat16 ahead of a train-mode
  BatchNorm at batch 8 leaves the gradients of both packages far from
  the exact ones (JAX's 0.04-0.30 from float64 in relative L2 norm), so
  the gradient vector is held to JAX's in relative L2 norm within
  ``BF16_GRAD_TOL`` 0.4 (measured 0.004-0.32). The policy itself is
  pinned by the distance to the float64 evaluation: the port's logits
  and gradients lie between ``1 / RATIO`` and ``RATIO`` times as far from
  it as JAX's (measured 0.74-1.73 for the logits, 0.99-1.14 for the
  gradients); a port that computed in float32 would lie a thousand times
  closer, a wrong gradient further.
- The Adam-updated parameters: Adam's first step moves a parameter by
  the learning rate times the sign of its gradient. The update is held
  where the float64 gradient lies above ``NOISE`` (1e-4) of the largest
  and JAX's is within a tenth of it (elsewhere the true gradient is 0,
  as for a convolution's bias before a train-mode BatchNorm, or its sign
  is lost in rounding): there the port's update equals JAX's within
  ``UPD_TOL`` (1e-3) of the learning rate plus the parameter's float32
  spacing on all but a share ``FLIP_SHARE`` of the values, where the
  port's gradient took the other sign: 1e-4 in float32 (measured 0,
  v200 4.2e-5), 0.02 in bfloat16 (measured 0-0.0154). Adam alone is held
  to optax on the same gradients everywhere
  (``test_adam_equals_optax``).
- Backbones (float32 train-mode logits at batch 8): ``BACKBONE_TOL``
  5e-4; the deep stacks' last stages normalize few values per channel.
  Measured: at most 2.1e-4 (resnet50v2).
"""
import copy

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_vi_network import _flat, _nest, _variables
from trex_tpu.models import training as jax_training
from trex_tpu.models import vi_network as jax_vi
from trex_tpu_torch.models import layers, training, vi_network, vi_params

F32_TOL = 1e-5
BF16_TOL = 0.05
BF16_GRAD_TOL = 0.4
RATIO = 2.0
NOISE = 1e-4
UPD_TOL = 1e-3
FLIP_SHARE = {"float32": 1e-4, "bfloat16": 0.02}
# float32 versions whose train-mode BatchNorm over a dense layer's 8 rows
# is held to the float64 evaluation beyond F32_TOL (see above)
ILL_CONDITIONED = ("v119", "v200")
LR = 1e-4
BACKBONE_TOL = 5e-4
# the augmentation transform against jax.scipy.ndimage.map_coordinates,
# in grey levels
AUG_TOL = 1e-3
N_CLASSES = 7
# version -> the input edge it trains at (small, valid for its pools)
TRAIN_VERSIONS = {"v118_3": 32, "v110": 32, "v119": 32, "v200": 36,
                  "smallmlp": 16}


def _jax_model(version, dtype):
    if version == "smallmlp":
        return jax_vi.SmallMLP(num_classes=N_CLASSES, dtype=dtype) \
            if dtype is not None else jax_vi.SmallMLP(num_classes=N_CLASSES)
    return jax_vi.build(version, N_CLASSES, dtype=dtype)


def _port_model(version, edge, flat, dtype):
    if version == "smallmlp":
        kw = {"dtype": dtype} if dtype is not None else {}
        m = vi_network.SmallMLP(num_classes=N_CLASSES, **kw)
    else:
        m = vi_network.build(version, N_CLASSES, dtype=dtype)
    m = layers.materialize(m, (edge, edge, 1))
    vi_params.from_flax_arrays(m, flat)
    return m


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, layers.Dropout):
            m.rate = 0.0
    return model


@pytest.fixture
def jax_no_dropout(monkeypatch):
    """flax's Dropout built with rate 0 while the test runs."""
    orig = flax.linen.Dropout

    def zero(rate, *a, **kw):
        return orig(0.0, *a, **kw)
    monkeypatch.setattr(flax.linen, "Dropout", zero)


def _batch(edge, n=8, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, edge, edge, 1)).astype(np.float32)
    y = (np.arange(n) % N_CLASSES).astype(np.int32)
    return x, y


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _err(got, want, scale=None):
    """The largest distance of `got` from `want`, relative to `scale`
    (want's largest absolute value, at least 1, when None)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if scale is None:
        scale = max(1.0, float(np.abs(want).max()))
    return float(np.abs(got - want).max()) / scale


def _grads_flax(model, grads) -> dict:
    """The port's gradients in the flax layout, by parameter key."""
    by_id = {id(p): g for p, g in zip(model.parameters(), grads)}
    return {k: to_flax(by_id[id(t)].numpy())
            for k, t, to_flax, _ in vi_params._entries(model)
            if k.startswith("params/")}


def _jax_state(jm, flat, lr=1e-4):
    v = _nest(flat)
    return jax_training.TrainState.create(
        apply_fn=jm.apply, params=v["params"],
        batch_stats=v.get("batch_stats", {}),
        dropout_rng=jax.random.PRNGKey(0), tx=optax.adam(lr))


def _l2(got, want):
    """The relative L2 (Frobenius) distance of `got` from `want`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_train_forward(version, dtype, flat, x, y):
    """The JAX package's train-mode logits, loss, gradients (flax layout)
    and updated batch statistics of one forward, in float64 numpy."""
    jm = _jax_model(version, dtype)
    v = _nest(flat)

    def loss_of(params, batch_stats):
        out, mut = jm.apply({"params": params, "batch_stats": batch_stats},
                            x, train=True, mutable=["batch_stats"])
        return jax_training.softmax_cross_entropy(out, y, N_CLASSES), \
            (out, mut.get("batch_stats", {}))
    (loss, (logits, stats)), g = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(v["params"], v.get("batch_stats", {}))

    def wide(d):
        return {k: np.asarray(a, np.float64) for k, a in d.items()}
    return np.asarray(logits, np.float64), float(loss), \
        wide(_flat({"params": g})), \
        wide(_flat({"params": {}, "batch_stats": stats}))


def _jax_float64(version, flat, x, y, monkeypatch):
    """The JAX package's step evaluated in float64 (the exact reference):
    every flax layer the trained versions build made with float64 compute
    and parameters, the variables and the input widened, under
    ``jax.enable_x64``."""
    with jax.enable_x64(True), monkeypatch.context() as m:
        for name in ("BatchNorm", "LayerNorm", "Dense", "Conv"):
            def wide(*a, _cls=getattr(flax.linen, name), **kw):
                return _cls(*a, **{**kw, "dtype": jnp.float64,
                                   "param_dtype": jnp.float64})
            m.setattr(flax.linen, name, wide)
        return _jax_train_forward(
            version, jnp.float64,
            {k: np.asarray(a, np.float64) for k, a in flat.items()},
            x.astype(np.float64), y)


def _train_forward(pm, x, y):
    """Train-mode logits, the loss, the gradients (flax layout) and the
    updated batch statistics of one forward of `pm`."""
    xt = _nchw(x).to(next(pm.parameters()).dtype)
    logits = pm(xt, train=True)
    loss = training.softmax_cross_entropy(logits, torch.from_numpy(y),
                                          N_CLASSES)
    grads = _grads_flax(pm, torch.autograd.grad(loss, list(
        pm.parameters())))
    stats = {k: v for k, v in vi_params.to_flax_arrays(pm).items()
             if k.startswith("batch_stats/")}
    return logits.detach().double().numpy(), float(loss.detach()), grads, \
        stats


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("version", sorted(TRAIN_VERSIONS))
def test_train_mode_and_step_equal_flax_and_optax(version, dtype,
                                                  jax_no_dropout,
                                                  monkeypatch):
    """Train-mode logits and updated batch statistics, the loss and its
    gradients, then one step's loss, Adam update and statistics, against
    the JAX package's (``make_train_step`` with optax), with the
    tolerances of the module's docstring."""
    edge = TRAIN_VERSIONS[version]
    jdt = jnp.float32 if dtype == "float32" else None
    tdt = torch.float32 if dtype == "float32" else None
    jm = _jax_model(version, jdt)
    flat = _variables(jm, edge, seed=len(version) + 3)
    x, y = _batch(edge)
    want = _jax_train_forward(version, jdt, flat, x, y)
    ref = _jax_float64(version, flat, x, y, monkeypatch)
    got = _train_forward(_no_dropout(_port_model(version, edge, flat, tdt)),
                         x, y)
    keys = sorted(want[2])
    assert sorted(got[2]) == keys
    assert sorted(got[3]) == sorted(want[3])
    assert (len(want[3]) > 0) == (version != "smallmlp")
    grads = [np.concatenate([a[k].ravel() for k in keys])
             for a in (got[2], want[2], ref[2])]
    g_max = float(np.abs(grads[2]).max())

    def close(got_v, want_v, ref_v, scale=None):
        """Max-norm: within the dtype's tolerance of JAX's value, or, for
        an ill-conditioned float32 version, no further from the float64
        value than RATIO times JAX's."""
        if dtype == "bfloat16":
            return _err(got_v, want_v, scale) <= BF16_TOL
        return _err(got_v, want_v, scale) <= F32_TOL or (
            version in ILL_CONDITIONED and _err(got_v, ref_v, scale)
            <= RATIO * _err(want_v, ref_v, scale))

    assert close(got[0], want[0], ref[0])
    assert close(got[1], want[1], ref[1])
    for k in want[3]:
        assert close(got[3][k], want[3][k], ref[3][k]), k
    if dtype == "float32":
        assert close(*grads, scale=g_max)
    else:
        assert _l2(grads[0], grads[1]) <= BF16_GRAD_TOL
        # bfloat16 rounding as JAX's: as far from the float64 values
        for dist, (g, w, r) in ((_err, (got[0], want[0], ref[0])),
                                (_l2, grads)):
            assert 1 / RATIO <= dist(g, r) / dist(w, r) <= RATIO

    # one step of each package's train step
    new, loss_j, _ = jax_training.make_train_step(N_CLASSES)(
        _jax_state(jm, flat, LR), jnp.asarray(x), jnp.asarray(y))
    pm = _no_dropout(_port_model(version, edge, flat, tdt))
    opt = training.adam(pm.parameters(), LR)
    loss_p, _ = training.make_train_step(pm, N_CLASSES)(
        opt, _nchw(x), torch.from_numpy(y).long(), None)
    assert close(float(loss_p), float(loss_j), ref[1])
    assert training.adam_steps(opt) == int(new.step) == 1
    after = vi_params.to_flax_arrays(pm)
    n_held = n_all = n_flip = 0
    for k, w in _flat({"params": new.params,
                       "batch_stats": new.batch_stats}).items():
        if k.startswith("batch_stats/"):
            assert close(after[k], w, ref[3][k]), k
            continue
        g = np.abs(ref[2][k])
        held = (g > NOISE * g_max) & (np.abs(want[2][k] - ref[2][k])
                                      < 0.1 * g)
        p0 = np.asarray(flat[k], np.float64)
        upd_p = np.asarray(after[k], np.float64) - p0
        upd_j = np.asarray(w, np.float64) - p0
        # within UPD_TOL of the learning rate and the parameter's rounding
        off = np.abs(upd_p - upd_j) > UPD_TOL * LR + np.spacing(
            np.abs(np.asarray(w, np.float32)))
        n_held, n_all = n_held + held.sum(), n_all + held.size
        n_flip += (off & held).sum()
    assert n_held > 0.1 * n_all  # 34-99 % held
    assert n_flip <= FLIP_SHARE[dtype] * n_held, n_flip / n_held


def test_adam_equals_optax():
    """The port's Adam fed the same gradients over three steps gives
    optax.adam's parameters and moments (float32)."""
    rng = np.random.default_rng(2)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    tx = optax.adam(1e-3)
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = training.adam(tp, 1e-3)
    for step in range(3):
        g = [rng.normal(0, 10.0 ** -step, s).astype(np.float32)
             for s in shapes]
        g[1][0] = 0.0
        upd, st = tx.update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.from_numpy(a)
        opt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0,
                                   atol=F32_TOL * float(np.abs(b).max()))
    for p, mu, nu in zip(tp, st[0].mu, st[0].nu):
        for name, b in (("exp_avg", mu), ("exp_avg_sq", nu)):
            np.testing.assert_allclose(opt.state[p][name].numpy(),
                                       np.asarray(b), rtol=1e-6, atol=1e-12)
    assert training.adam_steps(opt) == int(st[0].count) == 3


def test_batchnorm_biased_running_variance_and_momentum():
    """train=True: the batch's biased variance normalizes and enters the
    running statistics as momentum * old + (1 - momentum) * batch
    (flax's convention; torch.nn.BatchNorm2d updates with the unbiased
    variance and weighs the new value by its momentum)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(2.0, 3.0, (6, 3, 4, 5))
                         .astype(np.float32))
    bn = layers.BatchNorm(3, momentum=0.9)
    with torch.no_grad():
        bn.scale.fill_(1.0)
        bn.bias.zero_()
        bn.mean.fill_(0.5)
        bn.var.fill_(2.0)
    y = bn(x, train=True)
    xd = x.double().numpy()
    m = xd.mean(axis=(0, 2, 3))
    v = xd.var(axis=(0, 2, 3))  # biased (ddof 0)
    np.testing.assert_allclose(bn.mean.numpy(), 0.9 * 0.5 + 0.1 * m,
                               rtol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), 0.9 * 2.0 + 0.1 * v,
                               rtol=1e-5)
    want = (xd - m[:, None, None]) / np.sqrt(v[:, None, None] + 1e-5)
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-4)
    # torch's own layer would store other statistics
    tbn = torch.nn.BatchNorm2d(3, momentum=0.9)
    tbn.running_mean.fill_(0.5)
    tbn.running_var.fill_(2.0)
    tbn.train()(x)
    assert not np.allclose(tbn.running_var.numpy(), bn.var.numpy(),
                           rtol=1e-3)
    # outside train mode nothing moves
    before = bn.var.clone()
    bn(x)
    assert torch.equal(bn.var, before)
    # the default momentum is flax's 0.99 (the backbones' BatchNorms)
    assert layers.BatchNorm(3).momentum == 0.99


def test_focal_loss_equals_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 2, (9, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 9).astype(np.int32)
    for gamma in (0.0, 2.0):
        want = float(jax_training.focal_loss(jnp.asarray(logits),
                                             jnp.asarray(labels), 5, gamma))
        got = float(training.focal_loss(torch.from_numpy(logits),
                                        torch.from_numpy(labels), 5,
                                        gamma))
        assert abs(got - want) <= F32_TOL * max(1.0, abs(want))
    want = float(jax_training.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), 5))
    got = float(training.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), 5))
    assert abs(got - want) <= F32_TOL * max(1.0, abs(want))
    # gamma 0 is the cross-entropy
    assert float(training.focal_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels), 5, 0.0)) \
        == pytest.approx(got, rel=1e-6)


def test_dropout_keep_share_and_scaling():
    """Kept with probability 1 - rate, scaled by 1 / (1 - rate) in the
    input's type, drawn from the generator passed; identity outside
    train mode and at rate 0; train mode without a generator raises."""
    d = layers.Dropout(0.25)
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(3)
    y = d(x, train=True, rng=g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.005
    assert torch.all(y[kept] == 1 / 0.75)
    again = d(x, train=True, rng=torch.Generator().manual_seed(3))
    assert torch.equal(again, y)
    xb = torch.full((1000,), 1.5, dtype=torch.bfloat16)
    yb = d(xb, train=True, rng=g)
    assert yb.dtype == torch.bfloat16
    assert set(yb.float().unique().tolist()) <= {0.0, float(
        torch.tensor(1.5, dtype=torch.bfloat16) / 0.75)}
    assert d(x) is x
    assert layers.Dropout(0.0)(x, train=True) is x
    with pytest.raises(ValueError, match="generator"):
        d(x, train=True)


# one version per kind of layer the backbones train through, at the
# smallest input the tests of the zoo use
BACKBONES = {"resnet18": 32, "efficientnet_b0": 32,
             "mobilenet_v3_small": 48, "vitb16": 40, "vgg16": 32,
             "resnet50v2": 32, "xception": 32, "v100": 32}


@pytest.mark.parametrize("version", sorted(BACKBONES))
def test_backbone_train_mode_equals_flax(version, monkeypatch):
    """float32 train-mode logits and updated batch statistics of the
    zoo's other layer kinds (BACKBONE_TOL), dropout off on both sides,
    and the dropout
    rates in the order each network's train-mode call applies them
    (flax's Dropout calls against the port's)."""
    edge = BACKBONES[version]
    rates_j = []
    orig = flax.linen.Dropout

    def recorded(rate, *a, **kw):
        rates_j.append(rate)
        return orig(0.0, *a, **kw)
    monkeypatch.setattr(flax.linen, "Dropout", recorded)
    jm = jax_vi.build(version, N_CLASSES, dtype=jnp.float32)
    flat = _variables(jm, edge, seed=len(version))
    x, _ = _batch(edge)
    rates_j.clear()
    logits, mut = jax.jit(lambda v, x: jm.apply(
        v, x, train=True, mutable=["batch_stats"]))(_nest(flat),
                                                     jnp.asarray(x))
    pm = _port_model(version, edge, flat, torch.float32)
    rates_p = []
    for m in pm.modules():
        if isinstance(m, layers.Dropout):
            m.register_forward_pre_hook(
                lambda mod, args: rates_p.append(mod.rate))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        pm(_nchw(x), train=True, rng=g)  # dropout on: the rates
        assert rates_p == rates_j
        pm = _no_dropout(_port_model(version, edge, flat, torch.float32))
        got = pm(_nchw(x), train=True)
    assert _err(got.numpy(), logits) <= BACKBONE_TOL
    want = _flat({"params": {}, "batch_stats": mut.get("batch_stats", {})})
    got_stats = vi_params.to_flax_arrays(pm)
    for k in want:
        assert _err(got_stats[k], want[k]) <= BACKBONE_TOL, k


def test_augment_transform_equals_jax():
    """The port's transform fed the JAX draws of one PRNGKey gives
    make_augment_step's images within AUG_TOL grey levels; a batch whose
    shifts move corners outside the image included."""
    h = w = 24
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (6, h, w, 1)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax_training.make_augment_step(h, w)(
        key, jnp.asarray(images)))
    # the draws as make_augment_step takes them
    move_range = min(0.05, 2 / min(w, h))
    k = jax.random.split(key, 5)
    b = len(images)
    draws = dict(
        ang=jax.random.uniform(k[0], (b,), minval=-5.0, maxval=5.0)
        * (np.pi / 180.0),
        tx=jax.random.uniform(k[1], (b,), minval=-move_range,
                              maxval=move_range) * w,
        ty=jax.random.uniform(k[2], (b,), minval=-move_range,
                              maxval=move_range) * h,
        bright=jax.random.uniform(k[3], (b,), minval=0.85, maxval=1.15),
        contr=jax.random.uniform(k[4], (b,), minval=0.85, maxval=1.15))
    draws = {n: torch.from_numpy(np.array(v, np.float32))
             for n, v in draws.items()}
    got = training.augment_transform(_nchw(images), **draws)
    got = got.permute(0, 2, 3, 1).numpy()
    assert float(np.abs(got - want).max()) <= AUG_TOL
    # wider shifts and turns than the draws give: corners outside
    far = dict(ang=torch.tensor([0.5, -1.0, 0.0, 3.0, 0.2, -0.3]),
               tx=torch.tensor([5.5, -7.25, 23.5, 0.0, -30.0, 0.4]),
               ty=torch.tensor([-3.3, 8.0, 0.0, -23.9, 2.0, 0.6]),
               bright=torch.ones(6), contr=torch.ones(6))

    def jax_far(img, a, tx, ty):
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        yy, xx = jnp.mgrid[0:h, 0:w]
        yy = yy.astype(jnp.float32) - cy
        xx = xx.astype(jnp.float32) - cx
        ca, sa = jnp.cos(a), jnp.sin(a)
        sx = ca * xx + sa * yy + cx - tx
        sy = -sa * xx + ca * yy + cy - ty
        return jax.scipy.ndimage.map_coordinates(
            img, [sy, sx], order=1, mode="constant", cval=0.0)
    want = np.stack([np.asarray(jax_far(
        jnp.asarray(images[i, ..., 0]), float(far["ang"][i]),
        float(far["tx"][i]), float(far["ty"][i]))) for i in range(6)])
    got = training.augment_transform(_nchw(images), **far)[:, 0].numpy()
    assert (want == 0).sum() > 100  # samples outside the image
    # mean-contrast at factor 1 and brightness 1 leave the samples
    assert float(np.abs(got - np.clip(want, 0, 255)).max()) <= AUG_TOL
    # the draws' ranges
    d = training.augment_draws(1000, h, w, torch.Generator().manual_seed(1))
    assert float(d["ang"].abs().max()) <= 5 * np.pi / 180
    assert float(d["tx"].abs().max()) <= move_range * w
    assert 0.85 <= float(d["bright"].min()) and float(d["contr"].max()) \
        <= 1.15


def _train_pair(monkeypatch, n=60, edge=16, epochs=3, **kw):
    """The JAX and port trainers (float32 v118_3 with the same
    variables, dropout off) trained on the same small set; the labels
    of every batch each step saw are recorded."""
    orig = flax.linen.Dropout
    monkeypatch.setattr(flax.linen, "Dropout",
                        lambda rate, *a, **k: orig(0.0, *a, **k))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n, edge, edge, 1)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int32)
    images[labels == 1, 4:12, 4:12] = 250
    images[labels == 2, :, :4] = 5
    jt = jax_training.VITrainer(jax_vi.build("v118_3", 3, jnp.float32), 3,
                                (edge, edge, 1))
    pt = training.VITrainer(vi_network.build("v118_3", 3, torch.float32),
                            3, (edge, edge, 1), device="cpu")
    flat = _flat({"params": jt.state.params,
                  "batch_stats": jt.state.batch_stats})
    vi_params.from_flax_arrays(pt.model, flat)
    _no_dropout(pt.model)
    seen = {"j": [], "p": []}
    jstep, pstep = jt._train_step, pt._train_step

    def jrec(state, bi, bl):
        seen["j"].append(np.asarray(bl).copy())
        return jstep(state, bi, bl)

    def prec(opt, bi, bl, g):
        seen["p"].append(bl.numpy().copy())
        return pstep(opt, bi, bl, g)
    jt._train_step, pt._train_step = jrec, prec
    args = dict(max_epochs=epochs, batch_size=16, min_iterations=1, **kw)
    rj = jt.train(images, labels, **args)
    rp = pt.train(images, labels, **args)
    return jt, pt, rj, rp, seen, images


def test_train_equals_jax_trainer(monkeypatch):
    """VITrainer.train for 3 epochs, augmentation off: the same split
    and batch order, every history entry within F32_TOL, equal epochs
    and early stop; the trained networks' rows agree too."""
    jt, pt, rj, rp, seen, images = _train_pair(monkeypatch)
    assert len(seen["j"]) == len(seen["p"]) > 0
    for a, b in zip(seen["j"], seen["p"]):
        np.testing.assert_array_equal(a, b)
    assert rp.epochs == rj.epochs and rp.stopped_early == rj.stopped_early
    assert len(rp.history) == len(rj.history) == 3
    for a, b in zip(rj.history, rp.history):
        assert sorted(a) == sorted(b)
        for k in a:
            assert abs(a[k] - b[k]) <= F32_TOL * max(1.0, abs(a[k])), (k, a,
                                                                        b)
    np.testing.assert_array_equal(rp.per_class_accuracy,
                                  rj.per_class_accuracy)
    assert rp.best_worst_accuracy == rj.best_worst_accuracy
    # the rows: Adam moves the convolutions' biases before a BatchNorm
    # by the sign of rounding noise, which train mode subtracts but the
    # running means follow with a lag
    want = jt.predict(images[:20])
    got = pt.predict(images[:20])
    assert float(np.abs(got - want).max()) <= 1e-3


def test_train_early_stop_and_hooks_equal_jax(monkeypatch):
    """Early stop once the worst class reaches 0.99 after min_iterations,
    the uniqueness hook's entries and the callbacks, as the JAX trainer
    gives them."""
    calls = []
    _, _, rj, rp, _, _ = _train_pair(
        monkeypatch, epochs=40, uniqueness_fn=lambda: 0.5,
        callbacks=lambda e, entry: calls.append((e, entry["epoch"])))
    assert rj.stopped_early and rp.stopped_early
    assert rp.epochs == rj.epochs < 40
    assert calls == [(e, e) for e in range(rj.epochs)] * 2
    assert rp.uniqueness_history == rj.uniqueness_history \
        == [0.5] * rj.epochs
    assert [h["uniqueness"] for h in rp.history] == [0.5] * rp.epochs


def test_zero_one_scaled_inputs_warn():
    pt = training.VITrainer(vi_network.build("v118_3", 2), 2, (16, 16, 1),
                            device="cpu")
    images = np.random.default_rng(0).random((8, 16, 16, 1)) \
        .astype(np.float32)
    with pytest.warns(UserWarning, match="0-1 scaled"):
        pt.train(images, np.arange(8) % 2, max_epochs=1, batch_size=4,
                 min_iterations=1)


def test_state_snapshot_restores_weights_moments_and_step():
    """``state`` is a deep snapshot: training on after taking it leaves
    it as it was, and setting it back restores the parameters, batch
    statistics, Adam's moments and step and the dropout stream, so the
    next step repeats bit for bit; a snapshot restores twice."""
    pt = training.VITrainer(vi_network.build("v118_3", 3), 3, (16, 16, 1),
                            device="cpu", seed=4)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (8, 1, 16, 16))
                         .astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, 8))

    def step():
        return pt._train_step(pt.opt, x, y, pt._dropout_rng)

    def assert_opt_state(state):
        for i, st in frozen["opt"]["state"].items():
            assert sorted(state[i]) == sorted(st) == ["exp_avg",
                                                      "exp_avg_sq", "step"]
            for name, v in st.items():
                assert torch.equal(state[i][name], v)
    step()
    snap = pt.state
    frozen = copy.deepcopy(snap)
    first = [step()[0] for _ in range(2)]
    after = vi_params.to_flax_arrays(pt.model)
    for k, v in snap["model"].items():
        assert torch.equal(v, frozen["model"][k])
    assert_opt_state(snap["opt"]["state"])
    assert pt.steps == 3
    for _ in range(2):
        pt.state = snap
        assert pt.steps == 1
        assert_opt_state(pt.opt.state_dict()["state"])
        for k, v in pt.model.state_dict().items():
            assert torch.equal(v, snap["model"][k])
        again = [step()[0] for _ in range(2)]
        assert [float(a) for a in again] == [float(a) for a in first]
        for k, v in vi_params.to_flax_arrays(pt.model).items():
            np.testing.assert_array_equal(v, after[k])


def test_mesh_raises_naming_the_multi_gpu_item():
    """A mesh of one device is the plain trainer on it; a mesh of
    several devices in one process raises with the launch hint (one
    rank a card); a mesh of another kind raises."""
    from trex_tpu_torch.parallel import make_mesh

    x, y = _batch(16)
    trainers = [training.VITrainer(vi_network.build("v118_3", 2), 2,
                                   (16, 16, 1), **kw)
                for kw in (dict(mesh=make_mesh(1, device="cpu")),
                           dict(device="cpu"))]
    assert trainers[0].dp is None
    assert trainers[0].device == torch.device("cpu")
    hist = [t.train(x, y % 2, max_epochs=1, batch_size=4,
                    min_iterations=1).history for t in trainers]
    assert hist[0] == hist[1]
    with pytest.raises(ValueError, match="one rank a card.*torchrun"):
        training.VITrainer(vi_network.build("v118_3", 2), 2, (16, 16, 1),
                           mesh=make_mesh(2, device="cpu"))
    with pytest.raises(TypeError, match="Mesh"):
        training.VITrainer(vi_network.build("v118_3", 2), 2, (16, 16, 1),
                           device="cpu", mesh=object())
