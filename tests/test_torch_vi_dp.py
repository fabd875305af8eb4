"""Data-parallel training of the port's VITrainer (``mesh=``) on gloo
ranks on the CPU, against the JAX package's ``VITrainer(mesh=
make_mesh(8))`` and the port's single-process trainer.

The set of tests/test_ml.py::test_vi_training_sharded_over_mesh: v118_3
at 32x32 in float32, 4 classes, 128 images, batch 64, 2 epochs, the
images as their own validation set; both packages start from the same
variables (the JAX trainer's, through ``vi_params``). Ranks run
tests/torch_parallel_ranks.py::train_vi.

Tolerances (float32, the sums split over ranks in another order):
- every history entry within ``F32_TOL`` (1e-5 relative, as
  tests/test_torch_vi_train.py holds the single-process trainer to
  JAX's); the predictions within ``PROB_TOL`` 1e-3 (Adam moves
  parameters whose gradient is rounding noise by the noise's sign, as
  test_train_equals_jax_trainer explains);
- the BatchNorm running statistics after one step within ``STATS_TOL``
  1e-6 relative to each tensor's largest magnitude;
- the parameters after training equal bit for bit across ranks;
- the gradients the first Adam step takes, each rank's after the
  ranks' mean against the single process's on the whole batch, within
  ``GRAD_TOL`` 1e-4 relative to the largest gradient of the network
  (a wrong 1/world scale is off by a half: Adam's steps hide it);
- learn_static's default network computes in bfloat16: its losses
  within ``BF16_TOL`` 0.05 relative (tests/test_torch_vi_train.py's
  bfloat16 bound), epochs equal.
"""
import numpy as np
import pytest
import torch

import flax.linen
import jax.numpy as jnp

from trex_tpu.models import VITrainer as JaxTrainer
from trex_tpu.models import build as jax_build
from trex_tpu.parallel import make_mesh as jax_make_mesh
from trex_tpu_torch.models import VITrainer, build, vi_params
from trex_tpu_torch.parallel import distributed, make_mesh

import torch_parallel_ranks as ranks
from test_torch_vi_network import _flat

F32_TOL = 1e-5
PROB_TOL = 1e-3
STATS_TOL = 1e-6
GRAD_TOL = 1e-4
BF16_TOL = 0.05
N, NCLS, EDGE, BATCH = 128, 4, 32, 64
TRAIN = dict(max_epochs=2, batch_size=BATCH, min_iterations=1)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (N, EDGE, EDGE, 1)).astype(np.float32)
    labels = (np.arange(N) % NCLS).astype(np.int32)
    return images, labels


@pytest.fixture(scope="module")
def jax_run(data):
    """The JAX trainer over its 8 devices, dropout off: the initial
    variables, the history and the predictions of 64 images."""
    images, labels = data
    orig = flax.linen.Dropout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout",
                   lambda rate, *a, **k: orig(0.0, *a, **k))
        mesh = jax_make_mesh(8)
        jt = JaxTrainer(jax_build("v118_3", NCLS, jnp.float32), NCLS,
                        (EDGE, EDGE, 1), mesh=mesh)
        flat = _flat({"params": jt.state.params,
                      "batch_stats": jt.state.batch_stats})
        with mesh:
            res = jt.train(images, labels, val_images=images,
                           val_labels=labels, **TRAIN)
            probs = jt.predict(images[:64], batch_size=BATCH)
    return flat, res.history, probs


def _launch(n, flat, data, dropout, stats=False, mesh_kind="port",
            **train):
    images, labels = data
    train_kw = dict(TRAIN, num_classes=NCLS, val_images=images,
                    val_labels=labels, **train)
    return distributed.launch(ranks.train_vi, n, "cpu", flat, images,
                              labels, train_kw, 64, dropout, stats,
                              mesh_kind)


def _history_close(got, want):
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert sorted(a) == sorted(b)
        for k in a:
            assert abs(a[k] - b[k]) <= F32_TOL * max(1.0, abs(a[k])), \
                (k, a, b)


def _replicated(outs):
    for o in outs[1:]:
        assert sorted(o["params"]) == sorted(outs[0]["params"])
        for k, v in o["params"].items():
            np.testing.assert_array_equal(v, outs[0]["params"][k])


@pytest.mark.parametrize("n,mesh_kind", [(2, "port"), (4, "device_mesh")])
def test_dp_training_equals_jax_sharded_trainer(n, mesh_kind, data,
                                                jax_run):
    """Dropout off on both sides: every rank's history and predictions
    are the JAX sharded trainer's, and the ranks' parameters agree. Two
    ranks take the port's Mesh of every rank's device, four the
    DeviceMesh of hybrid_mesh(("data",))."""
    flat, want_hist, want_probs = jax_run
    outs = _launch(n, flat, data, False, mesh_kind=mesh_kind)
    for o in outs:
        _history_close(o["history"], want_hist)
        assert float(np.abs(o["probs"] - want_probs).max()) <= PROB_TOL
    _replicated(outs)


def test_dp_training_with_dropout_and_augmentation_equals_one_process(
        data, jax_run):
    """Dropout and augmentation on: 2 ranks draw what one process draws
    for the whole batch and keep their rows, so they train as the
    single-process trainer does; BatchNorm statistics after one step are
    the global batch's."""
    flat = jax_run[0]
    images, labels = data
    outs = _launch(2, flat, data, True, stats=True, augment=True)
    t = VITrainer(build("v118_3", NCLS, dtype=torch.float32), NCLS,
                  (EDGE, EDGE, 1), device="cpu")
    vi_params.from_flax_arrays(t.model, flat)
    kw = dict(TRAIN, val_images=images, val_labels=labels, augment=True)
    snap = t.state
    stats = ranks._one_step_stats(t, images, labels,
                                  dict(kw, max_epochs=1))
    t.state = snap
    t._aug_rng.manual_seed(7)
    res = t.train(images, labels, **kw)
    probs = t.predict(images[:64], batch_size=BATCH)
    for o in outs:
        _history_close(o["history"], res.history)
        assert float(np.abs(o["probs"] - probs).max()) <= PROB_TOL
        assert sorted(o["stats_one_step"]) == sorted(stats)
        for k, v in stats.items():
            err = np.abs(o["stats_one_step"][k] - v).max() \
                / max(np.abs(v).max(), 1e-30)
            assert err <= STATS_TOL, (k, err)
    _replicated(outs)


def test_dp_gradients_are_the_global_batch_mean(data, jax_run):
    """What the two ranks' all-reduce hands Adam is the gradient of the
    global batch's mean loss: scale and all, on every rank. (Four ranks'
    scale: the dryrun's gradient check, through the same reduction.)"""
    images, labels = data
    flat = jax_run[0]
    outs = distributed.launch(ranks.first_step_grads, 2, "cpu", flat,
                              images, labels, BATCH)
    want = ranks.first_step_grads(flat, images, labels, BATCH)
    top = max(float(np.abs(v).max()) for v in want.values())
    for o in outs:
        assert sorted(o) == sorted(want)
        err = max(float(np.abs(o[k] - v).max()) for k, v in want.items())
        assert err <= GRAD_TOL * top, (err, top)


def test_learn_static_over_two_ranks_equals_one(data, tmp_path):
    """Two ranks against one process; rank 0 writes the weights, which
    hold the ranks' parameters."""
    images, labels = data
    outs = distributed.launch(ranks.train_static, 2, "cpu", images,
                              labels, 2, BATCH, str(tmp_path / "dp"))
    from trex_tpu_torch.ml.learn_static import train_static

    _, res = train_static(images, labels, max_epochs=2, batch_size=BATCH,
                          mesh=make_mesh(1, device="cpu"), device="cpu")
    for o in outs:
        assert len(o["history"]) == len(res.history) == 2
        for a, b in zip(res.history, o["history"]):
            assert abs(a["loss"] - b["loss"]) <= BF16_TOL * abs(a["loss"])
    _replicated(outs)
    saved = VITrainer(build("v118_3", NCLS), NCLS, (EDGE, EDGE, 1),
                      device="cpu")
    saved.load_weights(tmp_path / "dp_weights.npz")
    for k, v in saved.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), outs[0]["params"][k])


def test_local_multi_device_mesh_needs_one_rank_a_card():
    with pytest.raises(ValueError, match="one rank a card"):
        VITrainer(build("v118_3", 2), 2, (16, 16, 1),
                  mesh=make_mesh(2, device="cpu"))
