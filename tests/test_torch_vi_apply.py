"""The VI apply slice as a whole: the port's trex CLI against the JAX
CLI, `-load -auto_apply -output_recognition_data true
-output_tracklet_images true -auto_quit` on the same .pv, .results and
weights npz (written by the JAX VITrainer: v118_3, one class per tracked
individual, 32x32 crops, where the small fish fill enough of the crop to
tell them apart).

Both predict every tracklet's normalized crops (bit-equal crops, the
network in bfloat16 on the CPU), average the rows per tracklet, assign
identities greedily by confidence, merge the corrections into
manual_matches and re-track with the object Tracker. The final dense
layer is a nearest-prototype head over the penultimate features
(`_prototype_head`), scaled by `HEAD_SCALE`, under which each
individual's tracklets are claimed by the next identity, so the
corrections reassign and the re-track runs. Every decision of the
assignment has a margin above twice `PROB_TOL` (asserted): the best
class against the second, the confidence against match_min_probability,
and the order of two tracklets that claim one class over overlapping
frames. The two networks' probability rows agree within `PROB_TOL`
(0.02, the bfloat16 policy's row tolerance `ROW_TOL` of
tests/test_torch_vi_network.py), so
the decisions are the same: the .results and the tracklet images are
byte-equal, and so is every array of the per-fish npz files but the
probabilities (the recognition rows, the visual_identification_p
column), which agree within `PROB_TOL`."""
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from test_torch_engine import one_torch_thread  # noqa: F401
from test_torch_vi_network import ROW_TOL
from trex_tpu.cli import trex as jax_cli
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.export.results import load_results as jax_load_results
from trex_tpu.ml.auto_correct import predict_tracklets as jax_predict
from trex_tpu.models.training import VITrainer as JaxTrainer
from trex_tpu.models.vi_network import build as jax_build
from trex_tpu.ops.crops import crops_for_individual as jax_crops
from trex_tpu.pipeline import TrackingState as JaxTrackingState
from trex_tpu_torch.cli import trex as port_cli
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ml import TrainingMode, VINetwork
from trex_tpu_torch.ml.uniqueness import (calculate_uniqueness,
                                          good_uniqueness)

HEAD_SCALE = 12.0
PROB_TOL = ROW_TOL
# the columns that carry the network's probabilities: the recognition
# export's rows and the per-fish files' visual_identification_p field
PROBABILITY_COLUMNS = ("probs", "visual_identification_p")
N = 5
# tracking settings of every CLI run: background subtraction and a speed
# limit keep each fish's tracklets long
TRACK = ["-track_threshold", "20", "-track_background_subtraction", "true",
         "-track_max_speed", "300", "-track_size_filter", "[[10,200]]",
         "-track_max_individuals", str(N), "-detect_threshold", "20",
         "-individual_image_size", "[32,32]"]


def _prototype_head(trainer, tracker, s):
    """The network's params with its last dense layer replaced by a
    nearest-prototype head: class k scores the projection of the
    penultimate features (relu of LayerNorm_0) on the direction of
    individual (k + 1) % n's mean features from the mean of all, times
    HEAD_SCALE. Every tracklet is claimed by another identity than its
    own, so the corrections reassign and the re-track runs."""
    import flax.linen as nn

    def features(images):
        _, inter = trainer.model.apply(
            {"params": trainer.state.params,
             "batch_stats": trainer.state.batch_stats},
            np.asarray(images, np.float32), train=False,
            capture_intermediates=lambda m, _: isinstance(m, nn.LayerNorm))
        return np.maximum(np.asarray(
            inter["intermediates"]["LayerNorm_0"]["__call__"][0]), 0)
    ids = sorted(tracker.individuals)
    protos = np.stack([features(jax_crops(tracker.individuals[f], tracker,
                                          s)[0]).mean(0) for f in ids])
    mu = protos.mean(0)
    u = protos - mu
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    u = np.roll(u, -1, axis=0)  # class k <- individual k + 1
    params = dict(trainer.state.params)
    params["Dense_1"] = {"kernel": (HEAD_SCALE * u.T).astype(np.float32),
                         "bias": (-HEAD_SCALE * u @ mu).astype(np.float32)}
    return params


def _run(cli, reset, argv, **kw):
    reset()
    try:
        return cli.main(argv, **kw)
    finally:
        reset()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Five fish of different sizes and stripes over 30 frames at 192^2, two of
    them crossing, converted and tracked by the JAX CLI (the object
    Tracker), and a weights npz from the JAX VITrainer with its head
    scaled by HEAD_SCALE."""
    root = tmp_path_factory.mktemp("vi_apply")
    rng = np.random.default_rng(21)
    pos = rng.uniform(30, 150, (N, 2))
    vel = rng.normal(0, 2.0, (N, 2))
    pos[1] = pos[0] + [44, 2]
    vel[0], vel[1] = [1.6, 0.1], [-1.6, 0.0]
    (root / "vid").mkdir()
    for i in range(30):
        img = np.full((192, 192), 210, np.uint8)
        for k, (x, y) in enumerate(pos):
            # each fish its own length, height and stripes
            xi, yi = int(x), int(y)
            w, h = 10 + 3 * k, 5 + k
            img[yi:yi + h, xi:xi + w] = 150 - 25 * k
            for j in range(k + 1):
                c = xi + 2 + 3 * j
                img[yi:yi + h, c:c + 1 + (k % 2)] = 20 + 10 * j
        cv2.imwrite(str(root / "vid" / f"f_{i:03d}.png"), img)
        pos = np.clip(pos + vel, 8, 168)
    src = root / "src"
    assert _run(jax_cli, jax_reset, [
        "-i", str(root / "vid" / "f_%03d.png"), "-o", "vid", "-d", str(src),
        "-task", "convert", "-nowindow", "-average_samples", "5",
        "-meta_encoding", "gray", "-averaging_method", "max"] + TRACK) == 0
    assert _run(jax_cli, jax_reset, [
        "-i", str(src / "vid.pv"), "-d", str(src / "t"), "-task", "track",
        "-nowindow", "-auto_quit", "-track_engine", "object"] + TRACK) == 0
    s = jax_reset()
    for k, v in zip(TRACK[::2], TRACK[1::2]):
        s.set(k[1:], jax_cli.parse_value(v))
    s.set("track_engine", "object")  # what -load restores into
    state = JaxTrackingState(s, src / "vid.pv")
    jax_load_results(state.tracker, src / "vid.results")
    n = len(state.tracker.individuals)
    trainer = JaxTrainer(jax_build("v118_3", n), n, (32, 32, 1), seed=4)
    trainer.state = trainer.state.replace(params=_prototype_head(
        trainer, state.tracker, s))
    trainer.save_weights(src / "vid_weights.npz")

    class Net:
        num_classes = n

        def probabilities(self, images):
            return trainer.predict(images)
    preds = jax_predict(state.tracker, s, Net())
    state.pv.close()
    jax_reset()
    return root, src, preds, float(s["match_min_probability"])


def test_assignment_margins_exceed_twice_the_tolerance(scene):
    """The decisions of assign_identities on the JAX network's averaged
    rows have margins above 2 * PROB_TOL, so rows that agree within
    PROB_TOL decide alike."""
    _, _, preds, min_p = scene
    assert len(preds) >= N
    top2 = [np.sort(p.probs)[-2:] for p in preds]
    best_margin = min(b - a for a, b in top2)
    threshold_margin = min(abs(p.confidence - min_p) for p in preds)
    # the order of two tracklets decides only where both claim one class
    # over overlapping frames
    order_margin = min(
        (abs(a.confidence - b.confidence) for i, a in enumerate(preds)
         for b in preds[i + 1:] if a.best_id == b.best_id
         and not (a.range[1] < b.range[0] or a.range[0] > b.range[1])),
        default=1.0)
    smallest = min(best_margin, threshold_margin, order_margin)
    assert smallest > 2 * PROB_TOL, (best_margin, threshold_margin,
                                     order_margin)


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_auto_apply_writes_the_jax_cli_files(scene, capfd):
    root, src, _, _ = scene
    dirs = {}
    for k in ("j", "p"):
        d = root / f"apply_{k}"
        d.mkdir()
        for name in ("vid.pv", "vid.results", "vid_weights.npz"):
            shutil.copy(src / name, d / name)
        dirs[k] = d
    argv = ["-task", "track", "-nowindow", "-auto_quit", "-load",
            "-auto_apply", "-output_recognition_data", "true",
            "-output_tracklet_images", "true"] + TRACK
    capfd.readouterr()
    assert _run(jax_cli, jax_reset, ["-i", str(dirs["j"] / "vid.pv"), "-d",
                                     str(dirs["j"] / "t")] + argv) == 0
    want_out = capfd.readouterr().out
    assert _run(port_cli, reset_global_settings,
                ["-i", str(dirs["p"] / "vid.pv"), "-d", str(dirs["p"] / "t")]
                + argv, device="cpu") == 0
    got_out = capfd.readouterr().out

    def corrections(out):
        return [ln for ln in out.splitlines()
                if ln.startswith("[auto_correct]")]
    assert corrections(got_out) == corrections(want_out)
    assert "re-tracking with corrections" in want_out
    assert "reassigned=0" not in want_out

    want, got = _tree(dirs["j"]), _tree(dirs["p"])
    assert sorted(got) == sorted(want)
    recog = [k for k in want if "_recognition_" in k]
    assert len(recog) >= N and "t/data/vid_tracklet_images.npz" in want
    assert "t/data/vid_tracklet_images_single_part0.npz" in want
    assert "vid.results" in want
    for name in want:
        if name in recog or name.startswith("t/data/vid_id"):
            a, b = np.load(dirs["j"] / name), np.load(dirs["p"] / name)
            assert a.files == b.files
            for col in a.files:
                x, y = a[col], b[col]
                assert x.dtype == y.dtype and x.shape == y.shape, (name, col)
                if col in PROBABILITY_COLUMNS:
                    np.testing.assert_allclose(y, x, rtol=0, atol=PROB_TOL)
                else:
                    assert x.tobytes() == y.tobytes(), (name, col)
            continue
        assert want[name] == got[name], name


def test_auto_apply_with_a_model_path_and_the_facade(scene, capfd):
    """visual_identification_model_path names the weights; a missing file
    prints the JAX CLI's note and the task goes on; the VINetwork facade
    loads the weights, and its training modes train."""
    root, src, preds, _ = scene
    d = root / "model_path"
    d.mkdir()
    for name in ("vid.pv", "vid.results"):
        shutil.copy(src / name, d / name)
    w = root / "elsewhere.npz"
    shutil.copy(src / "vid_weights.npz", w)
    base = ["-i", str(d / "vid.pv"), "-d", str(d / "t"), "-task", "track",
            "-nowindow", "-auto_quit", "-load", "-auto_apply"] + TRACK
    capfd.readouterr()
    assert _run(port_cli, reset_global_settings,
                base + ["-visual_identification_model_path", str(w)],
                device="cpu") == 0
    assert "[auto_correct] reassigned=" in capfd.readouterr().out
    assert _run(port_cli, reset_global_settings,
                base + ["-visual_identification_model_path",
                        str(root / "none.npz")], device="cpu") == 0
    assert f"[auto_apply] no weights at {root / 'none.npz'}" \
        in capfd.readouterr().err

    s = reset_global_settings()
    s.set("individual_image_size", [32, 32])
    net = VINetwork(s, device="cpu")
    n = preds[0].probs.shape[0]
    net.train(None, None, n, TrainingMode.LoadWeights,
              weights_file=src / "vid.pv")
    assert net.train(None, None, n, TrainingMode.Apply) is None
    images = np.random.default_rng(0).integers(
        0, 256, (2 * n, 32, 32, 1)).astype(np.uint8)
    labels = np.arange(2 * n) % n
    # Continue and Accumulate train the loaded network on (one step a
    # call), Restart a fresh one
    for mode, steps in ((TrainingMode.Continue, 1),
                        (TrainingMode.Accumulate, 2),
                        (TrainingMode.Restart, 1)):
        res = net.train(images, labels, n, mode, max_epochs=1)
        assert res.epochs == 1 and net.trainer.steps == steps
    rows = net.probabilities(np.zeros((3, 32, 32, 1), np.uint8))
    assert rows.shape == (3, n)
    np.testing.assert_allclose(rows.sum(1), 1.0, atol=1e-5)
    reset_global_settings()


def test_uniqueness_equals_jax():
    """calculate_uniqueness and good_uniqueness (host numpy) against the
    JAX package's on rows drawn from a seed."""
    from trex_tpu.ml import uniqueness as jax_uniqueness

    rng = np.random.default_rng(3)
    rows = rng.dirichlet(np.ones(6), 40).astype(np.float32)
    rows[5] = 0
    frames = {f: (f * 4, f * 4 + 4) for f in range(10)}
    frames[10] = (40, 40)
    want = jax_uniqueness.calculate_uniqueness(rows, frames, 6)
    got = calculate_uniqueness(rows, frames, 6)
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])
    for n in (1, 2, 3, 10, 251):
        assert good_uniqueness(n) == jax_uniqueness.good_uniqueness(n)


def test_vi_entry_points_need_cuda_unless_cpu_asked(scene):
    """Without CUDA, VITrainer, VINetwork and the CLI's -auto_apply raise
    unless the caller names the CPU."""
    import torch

    from trex_tpu_torch.models import VITrainer, build

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    root, src, _, _ = scene
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VITrainer(build("v118_3", 3), 3, (32, 32, 1))
    s = reset_global_settings()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VINetwork(s).load_weights(src / "vid_weights.npz", 3)
    d = root / "no_cuda"
    d.mkdir()
    for name in ("vid.pv", "vid.results", "vid_weights.npz"):
        shutil.copy(src / name, d / name)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run(port_cli, reset_global_settings,
             ["-i", str(d / "vid.pv"), "-d", str(d / "t"), "-task", "track",
              "-nowindow", "-auto_quit", "-load", "-auto_apply"] + TRACK)
