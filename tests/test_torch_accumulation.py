"""The accumulation curriculum of the port (trex_tpu_torch/ml/
accumulation.py, track/dataset_quality.py, track/foi.py) against the
JAX package's on the same scene: tests/test_ml.py's toy tracker, built
for both packages' object Trackers (with gaps, so that the video splits
into several global tracklet ranges).

The curriculum's decisions are held with a scripted trainer (the same
object for both packages: its predictions give each step the uniqueness
the script names, and it records every call), so the ranges, statuses,
reasons, rollbacks and maps are compared exactly; the real port trainer
then runs the curriculum on the CPU, as tests/test_ml.py runs the JAX
one, and a rejected step's rollback restores its weights."""
import numpy as np
import pytest
import torch

from test_torch_engine import one_torch_thread  # noqa: F401
from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.ml import accumulation as jax_acc
from trex_tpu.track import dataset_quality as jax_dq
from trex_tpu.track import foi as jax_foi
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.tracker import Tracker as JaxTracker
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ml import accumulation
from trex_tpu_torch.ml.uniqueness import calculate_uniqueness
from trex_tpu_torch.models import vi_params
from trex_tpu_torch.models.training import TrainResult
from trex_tpu_torch.track import dataset_quality, foi
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.tracker import Tracker

# (fish, frames) left out of the scene: fish 1 leaves over 9-11 and fish
# 2 over 20, so the global tracklet ranges are 0-8, 12-19 and 21-29
GAPS = {(1, 9), (1, 10), (1, 11), (2, 20)}


def toy_tracker(reset, tracker_cls, blob_cls, n_fish=3, n_frames=30,
                size=120, gaps=GAPS):
    """tests/test_ml.py's _toy_tracker for either package (its reset,
    Tracker and TrackBlob), fish left out at `gaps`."""
    s = reset()
    s.set("frame_rate", 25)
    s.set("track_max_speed", 200)
    s.set("cm_per_pixel", 1.0)
    s.set("track_threshold", 10)
    s.set("track_threshold_is_absolute", False)
    s.set("track_size_filter", [[5, 400]])
    s.set("track_max_individuals", n_fish)
    s.set("individual_image_size", [32, 32])
    s.set("individual_image_normalization", "none")
    s.set("calculate_posture", False)
    s.set("gpu_max_epochs", 10)
    s.set("gpu_min_iterations", 5)
    s.set("accumulation_max_tracklets", 3)
    s.set("accumulation_sufficient_uniqueness", 0.8)

    bg = np.full((size, size), 200, np.uint8)
    tracker = tracker_cls(s, background=bg)
    rng = np.random.default_rng(0)
    xs = [15 + i * 35 for i in range(n_fish)]
    for f in range(n_frames):
        blobs = []
        for i in range(n_fish):
            x = xs[i] + int(3 * np.sin(f / 4 + i))
            y = 30 + i * 25
            w, h = 6 + 3 * i, 9 - 2 * i  # distinct shapes per identity
            lines = np.array([[y + r, x, x + w - 1] for r in range(h)],
                             np.int32)
            val = 60 + 40 * i  # distinct darkness per identity
            px = np.full(w * h, val, np.uint8) + \
                rng.integers(0, 5, w * h).astype(np.uint8)
            if (i, f) not in gaps:
                blobs.append(blob_cls(lines, px))
        pp = tracker.preprocess_frame(f, blobs, time=f / 25)
        tracker.add(pp)
    return tracker, s


@pytest.fixture
def trackers():
    jt, js = toy_tracker(jax_reset, JaxTracker, JaxTrackBlob)
    pt, ps = toy_tracker(reset_global_settings, Tracker, TrackBlob)
    yield (jt, js), (pt, ps)
    jax_reset()
    reset_global_settings()


def _quality(q):
    return (q.start, q.end, q.individuals, q.min_cells, q.score, q.length)


def test_dataset_quality_equals_jax(trackers):
    (jt, _), (pt, _) = trackers
    assert sorted(jt.individuals) == sorted(pt.individuals)
    for n in (2, 5):
        ranges = dataset_quality.global_tracklet_ranges(pt, n)
        assert ranges == jax_dq.global_tracklet_ranges(jt, n)
    assert len(ranges) == 3
    for r in ranges + [(0, 29), (5, 14)]:
        assert _quality(dataset_quality.evaluate_range(pt, r)) \
            == _quality(jax_dq.evaluate_range(jt, r))
        for fid in pt.individuals:
            assert dataset_quality.evaluate_single(
                pt, pt.individuals[fid], *r) == jax_dq.evaluate_single(
                jt, jt.individuals[fid], *r)
    assert [_quality(q) for q in dataset_quality.best_ranges(pt)] \
        == [_quality(q) for q in jax_dq.best_ranges(jt)]


def test_resort_ranges_equals_jax():
    rng = np.random.default_rng(6)
    for _ in range(50):
        cands = sorted({(int(a), int(a + rng.integers(1, 30)))
                        for a in rng.integers(0, 300, 8)})
        trained = [cands[i] for i in rng.choice(len(cands), 2,
                                                replace=False)]
        umap = {int(f): float(rng.random()) for f in
                rng.choice(330, 120, replace=False)}
        if rng.random() < 0.2:
            umap = {f: 0.5 for f in umap}  # every average equal
        for tr in ([], trained):
            assert accumulation.resort_ranges(cands, tr, umap, (0, 329)) \
                == jax_acc.resort_ranges(cands, tr, umap, (0, 329))


def test_foi_store_equals_jax():
    stores = (foi.FOIStore(), jax_foi.FOIStore())
    seen = ([], [])
    for st, out in zip(stores, seen):
        st.on_add(out.append)
        for args in (("split", 3), ("split", 4, None, [1]),
                     ("split", 5, 7, [1], [9]), ("warn", 2, 2),
                     ("split", 9, 12, [1]), ("split", 13, None, [1], [4]),
                     ("warn", 10, 11, [2, 3])):
            st.add(*args)
    a, b = stores
    assert a.names() == b.names() and a.name_id("warn") == b.name_id("warn")
    for name in ("split", "warn", "none"):
        assert a.foi(name) == [foi.FOI(f.start, f.end, f.name, f.fdx, f.bdx)
                               for f in b.foi(name)]
        assert a.between(name, 4, 9) == [
            foi.FOI(f.start, f.end, f.name, f.fdx, f.bdx)
            for f in b.between(name, 4, 9)]
    assert [(f.start, f.end, f.fdx, f.bdx) for f in seen[0]] \
        == [(f.start, f.end, f.fdx, f.bdx) for f in seen[1]]
    assert a.foi("split")[0].overlaps(3) and not a.foi("warn")[0].overlaps(3)
    a.clear("split")
    b.clear("split")
    assert a.foi("split") == [] and a.foi("warn")
    a.clear()
    assert a.foi("warn") == []


class ScriptedTrainer:
    """A trainer whose predictions give each uniqueness evaluation the
    next value of `script`: every frame's rows name distinct identities
    with probability q (uniqueness logistic(q)), or, for a negative
    entry, all the same one. It records its calls; its weights are a
    version number that each train call advances and ``state`` snapshots."""

    def __init__(self, num_classes, script):
        self.num_classes = num_classes
        self.script = list(script)
        self.weights = 0
        self.log = []

    @property
    def state(self):
        self.log.append(("get", self.weights))
        return {"weights": self.weights}

    @state.setter
    def state(self, snap):
        self.log.append(("set", snap["weights"]))
        self.weights = snap["weights"]

    def train(self, images, labels, max_epochs, min_iterations, augment):
        self.weights += 1
        self.log.append(("train", len(images), labels.tolist(), max_epochs,
                         min_iterations, augment))
        return TrainResult(epochs=1, per_class_accuracy=np.full(
            self.num_classes, 0.5))

    def predict(self, images):
        q = self.script.pop(0)
        n = self.num_classes
        rows = np.full((len(images), n), (1 - abs(q)) / (n - 1),
                       np.float32)
        ids = np.arange(len(images)) % n if q > 0 else \
            np.zeros(len(images), int)
        rows[np.arange(len(images)), ids] = abs(q)
        self.log.append(("predict", len(images), q))
        return rows


def _step(st):
    return (st.range, st.status.value, st.reason.value, st.uniqueness,
            None if st.per_class_accuracy is None
            else st.per_class_accuracy.tolist())


# settings, the script (q > 0: uniqueness logistic(q), 0.78-1; q < 0:
# duplicates, about a third of that), the range whose crops are taken
# away (NotEnoughImages) and the statuses the run must show
SCENARIOS = {
    # added, rejected (< 0.95 of the best: rollback), added to success
    "reject_then_success": ({"accumulation_sufficient_uniqueness": 0.95,
                             "accumulation_enable_final_step": False},
                            [0.6, -0.9, 0.99], None,
                            {"added", "failed", "success"}),
    # an empty range between two added steps, no success
    "not_enough_images": ({"accumulation_sufficient_uniqueness": 0.99,
                           "accumulation_enable_final_step": False},
                          [0.6, 0.7], (0, 8), {"added", "failed"}),
    # three added steps, the final step helps: kept
    "final_step_kept": ({"accumulation_enable_final_step": True,
                         "accumulation_sufficient_uniqueness": 0.99},
                        [0.6, 0.7, 0.65, 0.9], None, {"added"}),
    # the final step hurts: rolled back to the weights before it
    "final_step_rolled_back": ({"accumulation_enable_final_step": True,
                                "accumulation_max_tracklets": 2,
                                "accumulation_sufficient_uniqueness": 0.99},
                               [0.6, 0.7, 0.5], None, {"added"}),
    # accumulation off: one range only, then the final step (rolled back)
    "accumulation_off": ({"accumulation_enable": False,
                          "accumulation_enable_final_step": True},
                         [0.7, 0.5], None, {"added", "success"}),
    # duplicates first, saved images and progress maps, augmentation on,
    # the threshold from good_uniqueness (0.95 for 3 individuals)
    "saved_outputs": ({"visual_identification_save_images": True,
                       "recognition_save_progress_images": True,
                       "vi_train_augment": True,
                       "accumulation_enable_final_step": True,
                       "accumulation_sufficient_uniqueness": 0},
                      [-0.9, 0.8, 0.99], None, {"added", "success"}),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_accumulation_equals_jax(trackers, monkeypatch, name):
    """Accumulation.start with the scripted trainer in both packages:
    equal steps (ranges, statuses, reasons, uniqueness), trained ranges,
    maps, success, saved images, and equal trainer calls, rollbacks
    included."""
    over, script, empty, kinds = SCENARIOS[name]
    results, trainers = [], []
    for (tracker, s), mod in zip(trackers, (jax_acc, accumulation)):
        for k, v in over.items():
            s.set(k, v)
        crops = mod.crops_for_individual

        def gated(ind, tracker, settings, frames=None, _crops=crops, **kw):
            if empty and frames == set(range(empty[0], empty[1] + 1)):
                frames = set()
            return _crops(ind, tracker, settings, frames=frames, **kw)
        monkeypatch.setattr(mod, "crops_for_individual", gated)
        tr = ScriptedTrainer(len(tracker.individuals), script)
        calls = []
        acc = mod.Accumulation(tracker, s, trainer=tr,
                               status_callback=lambda i, st, c=calls:
                               c.append((i, _step(st))))
        results.append((acc.start(max_epochs=8), calls))
        trainers.append(tr)
    (want, wcalls), (got, gcalls) = results
    assert [_step(st) for st in got.steps] == [_step(st) for st in want.steps]
    assert gcalls == wcalls
    assert got.trained_ranges == want.trained_ranges
    assert got.final_uniqueness == want.final_uniqueness
    assert got.uniqueness_map == want.uniqueness_map
    assert got.success == want.success
    assert got.progress_maps == want.progress_maps
    for a, b in ((got.training_images, want.training_images),
                 (got.training_labels, want.training_labels)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert trainers[1].log == trainers[0].log
    assert not trainers[1].script  # every scripted value was read
    shown = {st.status.value for st in got.steps} \
        | ({"success"} if got.success else set())
    assert shown == kinds
    log = trainers[1].log
    if name == "reject_then_success":
        # the rejected step restored the weights of the best step
        assert [st.reason.value for st in got.steps] == [
            "success", "uniqueness too low", "success"]
        assert ("set", 1) in log and log[log.index(("set", 1)) - 1][0] \
            == "predict"
    if name == "final_step_rolled_back":
        assert log[-1] == ("set", 2) and trainers[1].weights == 2
    if name == "final_step_kept":
        assert log[-2][0] == "train" and trainers[1].weights == 4
    if name == "not_enough_images":
        assert got.steps[1].reason.value == "not enough images"
    if name == "saved_outputs":
        assert len(got.progress_maps) == 2 and got.training_images.shape \
            == (len(got.training_labels), 32, 32, 1)


def test_accumulation_trains_to_success_on_the_cpu():
    """The real port trainer runs the curriculum on the toy scene (no
    gaps) to success, as tests/test_ml.py::test_accumulation_end_to_end
    asserts for the JAX package."""
    tracker, s = toy_tracker(reset_global_settings, Tracker, TrackBlob,
                             gaps=())
    acc = accumulation.Accumulation(tracker, s, device="cpu")
    result = acc.start(max_epochs=20)
    assert result.steps, "no accumulation steps ran"
    assert result.final_uniqueness > 0.8
    assert result.success
    reset_global_settings()


def test_rejected_step_restores_the_trained_weights(trackers):
    """With the real port trainer (the uniqueness scripted), a rejected
    step's rollback restores the weights, statistics and Adam state of
    the best step, not a reference to the live network."""
    _, (tracker, s) = trackers
    s.set("accumulation_sufficient_uniqueness", 0.99)
    s.set("accumulation_enable_final_step", False)
    acc = accumulation.Accumulation(tracker, s, device="cpu")
    trainer = acc.trainer
    n = acc.num_individuals
    script = [0.6, -0.9, 0.7]
    starts, ends = [], []
    train = trainer.train

    def snapshot():
        return vi_params.to_flax_arrays(trainer.model), trainer.steps

    def recorded_train(*a, **kw):
        starts.append(snapshot())
        out = train(*a, **kw)
        ends.append(snapshot())
        return out

    def step_uniqueness(images, map_indexes):
        rows = ScriptedTrainer(n, [script.pop(0)]).predict(images)
        return calculate_uniqueness(rows, map_indexes, n)[:3]
    trainer.train, acc.step_uniqueness = recorded_train, step_uniqueness
    result = acc.start(max_epochs=2)
    assert [st.reason.value for st in result.steps] == [
        "success", "uniqueness too low", "success"]
    # the third step started from the first step's trained weights and
    # Adam step, which the second step had moved on from
    (w1, c1), (w3, c3) = ends[0], starts[2]
    assert c3 == c1 and starts[1][1] == c1 and ends[1][1] > c1
    assert all(np.array_equal(w1[k], w3[k]) for k in w1)
    assert any(not np.array_equal(w1[k], ends[1][0][k]) for k in w1)
