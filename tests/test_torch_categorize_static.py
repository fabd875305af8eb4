"""Categorization, static-dataset training and the VINetwork facade's
training modes of the port (trex_tpu_torch/ml/categorize.py,
learn_static.py, vi_facade.py, cli/trex.py's _auto_categorize) on the
CPU, as tests/test_ml.py runs the JAX package's, with the labels held
to the JAX package's on the same scene.

The two packages train from different draws (parameters, dropout), so
their networks differ; the labels they give are compared where the
scene decides them: the labeled individuals, and every tracklet whose
mean probabilities the JAX network sets apart by more than ``MARGIN``
(the categorizer stops after its 10 minimum steps, once validation is
perfect, so its rows stay near a tie: 0.02-0.14 apart on this scene)."""
import re

import numpy as np
import pytest
import torch

from test_torch_accumulation import toy_tracker
from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.cli.trex import _auto_categorize as jax_auto_categorize
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.ml import Categorizer as JaxCategorizer
from trex_tpu.ml import TrainingMode as JaxTrainingMode
from trex_tpu.ml import VINetwork as JaxVINetwork
from trex_tpu.ml.categorize import DataStore as JaxDataStore
from trex_tpu.ml.learn_static import train_static as jax_train_static
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.tracker import Tracker as JaxTracker
from trex_tpu_torch.cli.trex import _auto_categorize
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ml import Categorizer, TrainingMode, VINetwork
from trex_tpu_torch.ml import learn_static
from trex_tpu_torch.ml.categorize import DataStore
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.tracker import Tracker

MARGIN = 0.1

# a line in glog's format: XLA's and absl's C++ log, never either CLI's
# (XLA writes one when its persistent compilation cache holds an entry
# that another machine compiled)
GLOG_LINE = re.compile(r"^[IWEF]\d{4} \d\d:\d\d:\d\d\.\d+ +\d+ \S+:\d+\] ")


def _cli_messages(text: str) -> str:
    """What a CLI printed: `text` without glog-format lines."""
    return "".join(line for line in text.splitlines(keepends=True)
                   if not GLOG_LINE.match(line))


def _scenes():
    jt, js = toy_tracker(jax_reset, JaxTracker, JaxTrackBlob, gaps=())
    pt, ps = toy_tracker(reset_global_settings, Tracker, TrackBlob, gaps=())
    return (jt, js), (pt, ps)


def _decided(jax_cat, tracker, applied):
    """The applied labels whose JAX mean probability is beyond MARGIN
    of a tie."""
    from trex_tpu.ops.crops import crops_for_individual

    out = {}
    for r in applied:
        crops, _ = crops_for_individual(tracker.individuals[r.fid], tracker,
                                        jax_cat.settings,
                                        frames=set(range(r.start, r.end + 1)))
        p = np.sort(jax_cat.trainer.predict(crops).mean(0))
        if p[-1] - p[-2] > MARGIN:
            out[(r.fid, r.start, r.end)] = r.label
    return out


def test_categorizer_equals_jax():
    """tests/test_ml.py::test_categorizer on both packages: the
    categories_train_min_tracklet_length gate raises below two samples a
    class, then training and apply label the dark and light fish, with
    the labels of the JAX package where it decides them."""
    (jt, js), (pt, ps) = _scenes()
    cats = []
    for tracker, s, cls, kw in ((jt, js, JaxCategorizer, {}),
                                (pt, ps, Categorizer, {"device": "cpu"})):
        cat = cls(s, ["dark", "light"], **kw)
        cat.store.set_ranged_label(0, 0, 29, "dark")
        cat.store.set_ranged_label(2, 0, 29, "light")
        with pytest.raises(ValueError, match="not enough labeled"):
            cat.train(tracker, max_epochs=20)
        s.set("categories_train_min_tracklet_length", 10)
        cat.train(tracker, max_epochs=20)
        cats.append((cat, cat.apply(tracker, min_tracklet_length=1)))
    (jc, japplied), (pc, papplied) = cats
    assert [(r.fid, r.start, r.end) for r in papplied] \
        == [(r.fid, r.start, r.end) for r in japplied]
    labels = {r.fid: r.label for r in papplied}
    assert labels[0] == 0 and labels[2] == 1
    assert pc.store.ranged_label(5, 0) == 0
    want = _decided(jc, jt, japplied)
    got = {(r.fid, r.start, r.end): r.label for r in papplied}
    assert len(want) >= 1 and all(got[k] == v for k, v in want.items())
    # the per-blob index the matching veto reads
    for f in (0, 17, 29):
        b = pt.individuals[2].basic_stuff(f)
        assert pc.store.blob_label(f, b.blob.blob_id) == 1
    jax_reset()
    reset_global_settings()


def test_auto_categorize_equals_jax(capfd):
    """tests/test_ml.py::test_cli_auto_categorize_flow on both CLIs: the
    labels of a loaded store are remapped by name onto
    categories_ordered (here in the other order), and with the
    registry's categories_train_min_tracklet_length (50) the 30-frame
    ranges leave nothing to train on, so both print the same note and
    keep the remapped store; with the gate at 10 both train and label."""
    for gate in (None, 10):
        (jt, js), (pt, ps) = _scenes()
        outs = []
        for tracker, s, store_cls, run, kw in (
                (jt, js, JaxDataStore, jax_auto_categorize, {}),
                (pt, ps, DataStore, _auto_categorize, {"device": "cpu"})):
            s["categories_ordered"] = ["light", "dark"]
            if gate:
                s.set("categories_train_min_tracklet_length", gate)
            store = store_cls(["dark", "light", "other"])
            store.set_ranged_label(0, 0, 29, "dark")
            store.set_ranged_label(2, 0, 29, "light")
            store.set_ranged_label(1, 0, 29, "other")  # not a category
            store.index_individual(tracker.individuals[0], 0, 29, "dark")
            tracker.category_store = store
            capfd.readouterr()
            run(tracker, s, None, **kw)
            cap = capfd.readouterr()
            out = tracker.category_store
            outs.append((_cli_messages(cap.out + cap.err), out))
            assert out.categories == ["light", "dark"]
            assert out.ranged_label(5, 0) == 1 and out.ranged_label(5, 2) == 0
            b = tracker.individuals[0].basic_stuff(3)
            assert out.blob_label(3, b.blob.blob_id) == 1
        (jmsg, jout), (pmsg, pout) = outs
        assert pmsg == jmsg
        assert ("cannot train" in pmsg) == (gate is None)
        if gate:
            assert "[auto_categorize] labeled" in pmsg
            assert [(r.fid, r.start, r.end) for r in pout.labeled_ranges()] \
                == [(r.fid, r.start, r.end) for r in jout.labeled_ranges()]
        else:
            assert [vars(r) for r in pout.labeled_ranges()] \
                == [vars(r) for r in jout.labeled_ranges()]
    # no categories: the note, and the store untouched
    (_, _), (pt, ps) = _scenes()
    pt.category_store = None
    _auto_categorize(pt, ps, None, device="cpu")
    assert "categories_ordered is empty" in capfd.readouterr().err
    assert pt.category_store is None
    jax_reset()
    reset_global_settings()


def _static_set(seed=0):
    """tests/test_ml.py::test_learn_static_entry's three classes of
    16x16 patterns."""
    rng = np.random.default_rng(seed)
    images = np.zeros((90, 16, 16), np.uint8)
    labels = np.repeat(np.arange(3), 30).astype(np.int32)
    images[labels == 0, 2:6, :] = 220
    images[labels == 1, :, 2:6] = 220
    images[labels == 2, 8:14, 8:14] = 220
    images = np.clip(images.astype(int)
                     + rng.integers(0, 30, images.shape), 0, 255
                     ).astype(np.uint8)
    return images, labels


def test_learn_static_entry(tmp_path, capfd):
    """learn_static as tests/test_ml.py runs the JAX one: the dataset
    loads as the JAX package loads it, sparse 1-based labels remap
    densely, training reaches the JAX package's accuracy bar and saves
    the weights; main prints its summary."""
    from trex_tpu.ml.learn_static import load_dataset as jax_load

    images, labels = _static_set()
    np.savez(tmp_path / "ds.npz", images=images, labels=labels * 2 + 1)
    imgs, lbls = learn_static.load_dataset(tmp_path / "ds.npz")
    want = jax_load(tmp_path / "ds.npz")
    np.testing.assert_array_equal(imgs, want[0])
    np.testing.assert_array_equal(lbls, want[1])
    assert imgs.dtype == np.float32 and imgs.shape == (90, 16, 16, 1)
    trainer, result = learn_static.train_static(
        imgs, lbls, version="v118_3", max_epochs=8, batch_size=32,
        output_prefix=str(tmp_path / "tagmodel"), device="cpu")
    assert (tmp_path / "tagmodel_weights.npz").exists()
    assert trainer.num_classes == 3
    acc = trainer.per_class_accuracy(imgs, np.repeat(np.arange(3), 30))
    assert acc.mean() > 0.8
    jtrainer, jresult = jax_train_static(imgs, lbls, version="v118_3",
                                         max_epochs=8, batch_size=32)
    assert result.epochs == jresult.epochs == 8
    with np.load(tmp_path / "tagmodel_weights.npz") as z:
        assert set(z.files) >= {"__meta__", "params/Dense_1/kernel"}
    capfd.readouterr()
    learn_static.main([str(tmp_path / "ds.npz"), "--epochs", "2",
                       "--output", str(tmp_path / "cli")], device="cpu")
    assert capfd.readouterr().out.startswith("trained 2 epochs; per-class "
                                             "accuracy mean ")
    assert (tmp_path / "cli_weights.npz").exists()
    # a mesh of one device is the plain trainer on that device
    from trex_tpu_torch.parallel import make_mesh

    meshed, mres = learn_static.train_static(
        imgs, lbls, max_epochs=2, batch_size=32,
        mesh=make_mesh(1, device="cpu"))
    plain, pres = learn_static.train_static(imgs, lbls, max_epochs=2,
                                            batch_size=32, device="cpu")
    assert meshed.dp is None and meshed.device == torch.device("cpu")
    assert mres.history == pres.history


def test_vi_network_facade_modes(tmp_path):
    """tests/test_ml.py::test_vi_network_facade on the port, with the
    modes Continue and Accumulate training on from where the network
    stands, Restart from fresh weights, the status callbacks, and the
    messages the JAX facade emits."""
    s = reset_global_settings()
    s.set("individual_image_size", [16, 16])
    s.set("gpu_max_epochs", 5)
    s.set("gpu_min_iterations", 2)
    js = jax_reset()
    for k in ("individual_image_size", "gpu_max_epochs",
              "gpu_min_iterations"):
        js.set(k, s[k])
    net = VINetwork(s, device="cpu")
    jnet = JaxVINetwork(js)
    msgs, jmsgs = [], []
    net.status_callbacks.append(msgs.append)
    jnet.status_callbacks.append(jmsgs.append)
    rng = np.random.default_rng(0)
    images = np.zeros((60, 16, 16, 1), np.float32)
    labels = rng.integers(0, 2, 60)
    images[labels == 1, 4:12, 4:12] = 220
    res = net.train(images, labels, 2, TrainingMode.Restart,
                    weights_file=tmp_path / "model.pt")
    jnet.train(images, labels, 2, JaxTrainingMode.Restart)
    assert res.epochs == 5
    probs = net.probabilities(images[:4])
    assert probs.shape == (4, 2)
    assert (tmp_path / "model_weights.npz").exists()
    net2 = VINetwork(s, device="cpu")
    net2.train(images, labels, 2, TrainingMode.LoadWeights,
               weights_file=tmp_path / "model.pt")
    np.testing.assert_allclose(net2.probabilities(images[:4]), probs,
                               atol=1e-5)
    # Continue and Accumulate train the same network on: Adam's step
    # carries over; Restart starts a fresh one
    trainer = net.trainer
    steps = trainer.steps
    for mode, jmode in ((TrainingMode.Continue, JaxTrainingMode.Continue),
                        (TrainingMode.Accumulate,
                         JaxTrainingMode.Accumulate)):
        net.train(images, labels, 2, mode, max_epochs=1)
        jnet.train(images, labels, 2, jmode, max_epochs=1)
        assert net.trainer is trainer and trainer.steps > steps
        steps = trainer.steps
    net.train(images, labels, 2, TrainingMode.Restart, max_epochs=1)
    assert net.trainer is not trainer and net.trainer.steps < steps
    jnet.train(images, labels, 2, JaxTrainingMode.Restart, max_epochs=1)
    assert msgs == jmsgs == [
        "training 60 samples (restart)", "training 60 samples (continue)",
        "training 60 samples (accumulate)", "training 60 samples (restart)"]
    net.save_weights(tmp_path / "saved.npz")
    assert (tmp_path / "saved.npz").exists()
    with pytest.raises(RuntimeError, match="not set"):
        VINetwork(s, device="cpu").save_weights(tmp_path / "x.npz")
    # one facade per settings object
    assert VINetwork.instance(s, device="cpu") is VINetwork.instance(s)
    assert VINetwork.instance(reset_global_settings()) is not \
        VINetwork.instance(s)
    assert isinstance(net.trainer.model.Dense_1.weight, torch.nn.Parameter)
    jax_reset()
    reset_global_settings()


def test_training_entry_points_need_cuda_unless_cpu_asked(tmp_path):
    """Without CUDA the training entry points raise unless the caller
    names the CPU: the accumulation, the categorizer, the facade's
    training modes, learn_static and the CLI's -auto_train and
    -auto_categorize; none falls back to the CPU."""
    from trex_tpu_torch.cli import trex as port_cli
    from trex_tpu_torch.ml import Accumulation

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    (_, _), (pt, ps) = _scenes()
    images, labels = _static_set()
    calls = [lambda: Accumulation(pt, ps),
             lambda: Categorizer(ps, ["a", "b"]),
             lambda: VINetwork(ps).train(images[..., None], labels, 3),
             lambda: learn_static.train_static(images, labels),
             lambda: learn_static.main([str(tmp_path / "none.npz")])]
    np.savez(tmp_path / "none.npz", images=images, labels=labels)
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    from trex_tpu_torch.io.pv import PVFile, PVFrame, PVHeader

    pv = tmp_path / "v.pv"
    with PVFile.create(pv, PVHeader(width=16, height=16, timestamp=1,
                                    average=np.full((16, 16), 200,
                                                    np.uint8))) as f:
        for i in range(3):
            fr = PVFrame(timestamp=1 + i, source_index=i)
            fr.add_object(np.array([[3, 2, 9]], np.int32),
                          np.full(8, 60, np.uint8))
            f.add_frame(fr)
    for flag in ("-auto_train", "-auto_categorize"):
        reset_global_settings()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_cli.main(["-i", str(pv), "-d", str(tmp_path / "out"),
                           "-task", "track", "-auto_quit", "-track_engine",
                           "object", "-error_terminate", "false", flag,
                           "-categories_ordered", "[a,b]"])
    reset_global_settings()
