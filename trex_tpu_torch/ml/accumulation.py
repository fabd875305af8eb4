"""Accumulation curriculum: idtrackerai-style range-by-range VI training.

Re-creates Accumulation (reference ui/Accumulation.{h,cpp}:914-1700):

1. build a global discrimination sample set across the video
2. pick the best global tracklet range (DatasetQuality)
3. train on it; predict the discrimination set; compute uniqueness
4. greedily add the next range whose predicted-id coverage is weakest
   (assigned_unique_averages) until uniqueness >= threshold or
   accumulation_max_tracklets is exhausted; each step accepts/rejects
   per AccumulationStatus/Reason
5. optional final overfit step (accumulation_enable_final_step)

Statuses mirror the reference enums (Accumulation.h:29-30).

Counterpart of ``trex_tpu/ml/accumulation.py``: the network trains and
predicts on the card unless the caller names the CPU (``device``); the
rollback restores the trainer's deep ``state`` snapshot.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..ops.crops import crops_for_individual
from ..track.dataset_quality import best_ranges
from .uniqueness import calculate_uniqueness, good_uniqueness


class AccumulationStatus(enum.Enum):
    Added = "added"
    Cached = "cached"
    Failed = "failed"
    None_ = "none"


class AccumulationReason(enum.Enum):
    NoUniqueIDs = "no unique ids"
    ProbabilityTooLow = "probability too low"
    NotEnoughImages = "not enough images"
    TrainingFailed = "training failed"
    UniquenessTooLow = "uniqueness too low"
    Success = "success"
    Skipped = "skipped"


@dataclass
class AccumulationStep:
    range: tuple
    status: AccumulationStatus
    reason: AccumulationReason
    uniqueness: float = 0.0
    per_class_accuracy: Optional[np.ndarray] = None


@dataclass
class AccumulationResult:
    steps: list = field(default_factory=list)
    final_uniqueness: float = 0.0
    uniqueness_map: dict = field(default_factory=dict)
    trained_ranges: list = field(default_factory=list)
    success: bool = False
    # visual_identification_save_images: the successful training set
    training_images: Optional[np.ndarray] = None
    training_labels: Optional[np.ndarray] = None
    # recognition_save_progress_images: per-step uniqueness maps
    progress_maps: list = field(default_factory=list)


def resort_ranges(candidates: list, trained: list, unique_map: dict,
                  analysis_range: tuple) -> list:
    """Coverage-driven ordering of the remaining candidate ranges
    (Accumulation.cpp resort_ranges :1207-1292 /
    assigned_unique_averages): for each candidate not overlapping an
    already-trained range, average the CURRENT per-frame uniqueness
    over a window of +-(analysis_length/10) around its center; the
    candidate whose surroundings have the LOWEST predicted uniqueness
    sorts first (train where the network is weakest). Scores bucketize
    to steps of 5 like the reference; ties break toward ranges
    FARTHEST (pow2-bucketed) from what was already used. Overlapping
    candidates sort last."""
    if not trained:
        return list(candidates)
    lo, hi = analysis_range
    win = max(1, (hi - lo + 1) // 10)
    rows = []
    averages = {}
    for rng in candidates:
        overlaps = any(rng[0] <= t1 and t0 <= rng[1]
                       for t0, t1 in trained)
        if overlaps:
            rows.append((None, 0, rng))
            continue
        center = rng[0] + (rng[1] - rng[0]) // 2
        e0, e1 = max(lo, center - win), min(hi, center + win)
        vals = [u for f, u in unique_map.items() if e0 <= f <= e1]
        avg = float(np.mean(vals)) if vals else 0.0
        averages[rng] = avg
        gap = min(min(abs(rng[0] - t1), abs(t0 - rng[1]))
                  for t0, t1 in trained)
        rows.append((avg, 1 << max(0, int(gap)).bit_length(), rng))
    if averages:
        mn, mx = min(averages.values()), max(averages.values())
    else:
        mn = mx = 0.0
    scored = []
    for avg, gap_b, rng in rows:
        if avg is None:
            scored.append((-1.0, 0, rng))
            continue
        d = 100.0 - (((avg - mn) / (mx - mn)) * 100.0 if mx > mn else 0.0)
        d = round(round(d) * 2.0 / 10.0) / 2.0 * 10.0
        scored.append((d, gap_b, rng))
    scored.sort(key=lambda t: (-t[0], -t[1], t[2]))
    return [rng for _, _, rng in scored]


class Accumulation:
    def __init__(self, tracker, settings, trainer=None,
                 status_callback: Optional[Callable] = None, device=None):
        self.tracker = tracker
        self.settings = settings
        self.status_callback = status_callback
        s = settings
        self.num_individuals = len(tracker.individuals)
        size = s["individual_image_size"]
        self.image_shape = (int(size[1]), int(size[0]), 1)
        if trainer is None:
            from ..models import VITrainer, build

            model = build(s["visual_identification_version"],
                          self.num_individuals)
            trainer = VITrainer(model, self.num_individuals,
                                self.image_shape,
                                learning_rate=s["gpu_learning_rate"],
                                device=device)
        self.trainer = trainer
        self._median_lengths = {}
        for fid, ind in tracker.individuals.items():
            lengths = [p.midline_length for p in ind.posture
                       if not math.isnan(p.midline_length)]
            self._median_lengths[fid] = (float(np.median(lengths))
                                         if lengths else None)

    # ------------------------------------------------------------------
    def _collect(self, frame_range: tuple):
        """(images, labels) crops for all individuals in the range."""
        t0, t1 = frame_range
        frames = set(range(t0, t1 + 1))
        images, labels = [], []
        ids = sorted(self.tracker.individuals.keys())
        id_to_label = {fid: i for i, fid in enumerate(ids)}
        for fid in ids:
            ind = self.tracker.individuals[fid]
            crops, got = crops_for_individual(
                ind, self.tracker, self.settings, frames=frames,
                median_midline_length=self._median_lengths[fid])
            if len(crops):
                images.append(crops)
                labels.append(np.full(len(crops), id_to_label[fid]))
        if not images:
            return (np.zeros((0, *self.image_shape), np.uint8),
                    np.zeros(0, np.int64))
        return np.concatenate(images), np.concatenate(labels)

    def generate_discrimination_data(self, n_frames: int = 100):
        """Global per-frame sample set for uniqueness
        (Accumulation.h:177)."""
        start, end = self.tracker.start_frame, self.tracker.end_frame
        frames = np.unique(np.linspace(start, end,
                                       min(n_frames, end - start + 1))
                           .astype(int))
        ids = sorted(self.tracker.individuals.keys())
        frame_set = {int(f) for f in frames}
        # one pass per individual (crops_for_individual scans the whole
        # basic list; per-(frame, individual) calls were O(F x I x N))
        per_fish: dict[int, dict[int, np.ndarray]] = {}
        for fid in ids:
            ind = self.tracker.individuals[fid]
            crops, got = crops_for_individual(
                ind, self.tracker, self.settings, frames=frame_set,
                median_midline_length=self._median_lengths[fid])
            per_fish[fid] = {int(g): crops[k]
                             for k, g in enumerate(got)}
        images = []
        map_indexes = {}
        for f in frames:
            row_start = len(images)
            for fid in ids:
                crop = per_fish[fid].get(int(f))
                if crop is not None:
                    images.append(crop)
            if len(images) > row_start:
                map_indexes[int(f)] = (row_start, len(images))
        if not images:
            return np.zeros((0, *self.image_shape), np.uint8), {}
        return np.stack(images), map_indexes

    # ------------------------------------------------------------------
    def step_uniqueness(self, disc_images, map_indexes):
        if len(disc_images) == 0:
            return 0.0, {}, 0.0
        preds = self.trainer.predict(disc_images)
        good, per_frame, mean_p, _ = calculate_uniqueness(
            preds, map_indexes, self.num_individuals)
        return good, per_frame, mean_p

    def start(self, max_epochs: Optional[int] = None) -> AccumulationResult:
        s = self.settings
        result = AccumulationResult()
        if self.num_individuals == 0:
            return result
        max_epochs = max_epochs or int(s["gpu_max_epochs"])
        # accumulation_enable=false: train ONCE on the best global
        # tracklet range, no accumulation curriculum
        # (Accumulation.cpp gate)
        max_steps = 1 if not s["accumulation_enable"] \
            else int(s["accumulation_max_tracklets"])
        sufficient = float(s["accumulation_sufficient_uniqueness"]) or \
            good_uniqueness(self.num_individuals)
        ranges = best_ranges(self.tracker)
        if not ranges:
            return result
        disc_images, map_indexes = self.generate_discrimination_data()

        analysis_range = (self.tracker.start_frame,
                          self.tracker.end_frame)
        trained: list[tuple] = []
        images = labels = None
        best_uniqueness = -1.0
        best_state = None
        # candidate queue: DatasetQuality order seeds the FIRST range;
        # afterwards each step re-ranks the remainder by predicted
        # coverage — lowest surrounding uniqueness first
        # (Accumulation.cpp:1523 update_meta_start_acc + resort_ranges)
        candidates = [(rq.start, rq.end) for rq in ranges]
        step_i = -1
        while candidates and step_i + 1 < max_steps:
            step_i += 1
            candidates = resort_ranges(candidates, trained,
                                       result.uniqueness_map, analysis_range)
            rng = candidates.pop(0)
            imgs, labs = self._collect(rng)
            if len(imgs) < self.num_individuals * 2:
                result.steps.append(AccumulationStep(
                    rng, AccumulationStatus.Failed,
                    AccumulationReason.NotEnoughImages))
                continue
            prev_n = 0 if images is None else len(images)
            images = imgs if images is None else np.concatenate(
                [images, imgs])
            labels = labs if labels is None else np.concatenate(
                [labels, labs])
            tr = self.trainer.train(images, labels, max_epochs=max_epochs,
                                    min_iterations=int(s["gpu_min_iterations"]),
                augment=bool(s.get("vi_train_augment", False)))
            good, per_frame, mean_p = self.step_uniqueness(
                disc_images, map_indexes)
            # accept/reject (Accumulation.cpp end_a_step): a range whose
            # training WORSENS uniqueness is rejected — weights restore
            # from the pre-step cache and its images leave the set
            if best_state is not None and mean_p < best_uniqueness * 0.95:
                self.trainer.state = best_state
                images = images[:prev_n]
                labels = labels[:prev_n]
                step = AccumulationStep(
                    rng, AccumulationStatus.Failed,
                    AccumulationReason.UniquenessTooLow,
                    uniqueness=mean_p)
                result.steps.append(step)
                if self.status_callback:
                    self.status_callback(step_i, step)
                continue
            if mean_p >= best_uniqueness:
                best_uniqueness = mean_p
                best_state = self.trainer.state
            result.uniqueness_map = per_frame
            result.final_uniqueness = mean_p
            if s["recognition_save_progress_images"]:
                result.progress_maps.append(
                    (step_i, rng, dict(per_frame)))
            trained.append(rng)
            step = AccumulationStep(rng, AccumulationStatus.Added,
                                    AccumulationReason.Success,
                                    uniqueness=mean_p,
                                    per_class_accuracy=tr.per_class_accuracy)
            result.steps.append(step)
            if self.status_callback:
                self.status_callback(step_i, step)
            if mean_p >= sufficient:
                result.success = True
                break
        # final overfit step over everything collected
        if s["accumulation_enable_final_step"] and images is not None \
                and len(images):
            pre_state = self.trainer.state
            self.trainer.train(images, labels,
                               max_epochs=max(5, max_epochs // 4),
                               min_iterations=int(s["gpu_min_iterations"]),
                augment=bool(s.get("vi_train_augment", False)))
            good, per_frame, mean_p = self.step_uniqueness(
                disc_images, map_indexes)
            if mean_p >= result.final_uniqueness:
                result.final_uniqueness = mean_p
                result.uniqueness_map = per_frame
            else:
                # the overfit step hurt: keep the better network so the
                # reported uniqueness and the weights agree
                self.trainer.state = pre_state
        result.trained_ranges = trained
        if result.final_uniqueness >= sufficient:
            result.success = True
        if s["visual_identification_save_images"] and images is not None:
            # retain the successful training set for the CLI to save
            # to output_dir (reference: 'save the images used for a
            # successful training of the visual identification')
            result.training_images = images
            result.training_labels = labels
        return result
