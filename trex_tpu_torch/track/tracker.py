"""The per-frame tracking orchestrator: the object Tracker.

Counterpart of ``trex_tpu/track/tracker.py`` (the reference's
track::Tracker, tracking/Tracker.h:170, Tracker.cpp:562-2131):

    preprocess_frame -> prefilter blobs (threshold, size, shapes)
    add(frame):
        HistorySplit (split blobs expected to hold >1 individual)
        build per-individual caches (estimated position, time prob)
        calculate_paired_probabilities (S*T, match_min_probability gate)
        match (per-clique optimal / greedy per match_mode)
        assign matched blobs; second pass: unassigned blobs -> inactive
        individuals, then new individuals while under
        track_max_individuals
        update tracklets + per-frame statistics

The probability matrix is computed vectorized over (fish x blob); the
O(F*B) math matches Individual::probability exactly (see individual.py).
It is host code in float64 numpy, the JAX package's own arithmetic. It
takes every tracking setting, the ones both fast engines refuse
included (the registry's defaults ``track_threshold 0`` and
``track_background_subtraction false``, manual matches and splits, the
shape filters, categories, ``match_topk``, ``match_mode=benchmark``), tag detection (``tags_enable``) and
recognition (``tags_recognize``): the tag crops and gates on the host
(``track/tags.py``), the tag network on the tracker's device
(``ml/tagwork.py``).
"""
from __future__ import annotations

import sys
import time as _time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import SettingsView
from .blob import TrackBlob
from .cache_batch import compute_caches
from .individual import Individual, IndividualCache
from .matching import MatchResult, PairedProbabilities, match
from .prefilter import PrefilterResult, SizeFilters, prefilter
from .splitting import HistorySplit, split_blob

@dataclass
class PPFrame:
    """Preprocessed frame (reference tracking/PPFrame.h:64-720)."""
    index: int
    time: float  # seconds since video start
    timestamp: int = 0  # µs
    blobs: list = field(default_factory=list)
    noise: list = field(default_factory=list)
    big: list = field(default_factory=list)

    @property
    def n(self):
        return len(self.blobs)


@dataclass
class FrameStatistics:
    number_fish: int = 0
    adding_seconds: float = 0.0
    loading_seconds: float = 0.0
    posture_seconds: float = 0.0
    match_improvements: int = 0


class Tracker:
    def __init__(self, settings, background: Optional[np.ndarray] = None,
                 device=None):
        """`device` is where the tag network runs (``tags_recognize``
        with a readable ``tags_model_path``); everything else is host
        code."""
        settings = self.settings = SettingsView(settings)
        self.background = background
        self.individuals: dict[int, Individual] = {}
        self.active: set[int] = set()
        self.frame_times: dict[int, float] = {}
        self.statistics: dict[int, FrameStatistics] = {}
        self.start_frame: int = -1
        self.end_frame: int = -1
        self._history_split = HistorySplit(settings)
        self._next_id = 0
        self.manual_matches = settings["manual_matches"] or {}
        # VI / tag predictions store: frame -> {blob_id: probs}, which
        # the VI apply fills (ml/auto_correct.py) and the export reads
        self.predicted: dict[int, dict] = {}
        # physical-tag assignments: frame -> {identity: tag_id}
        # (Tracker.cpp:2056-2108 QR-tag <-> fish Hungarian matching)
        self.tag_assignments: dict[int, dict[int, int]] = {}
        # decode confidence parallel to tag_assignments (qr_p field)
        self.tag_assignment_p: dict[int, dict[int, float]] = {}
        # per-fish matched Tag records for the tags_path NPZ export
        self.detected_tags: dict[int, list] = {}
        # detect_tags' counters over the frames (track/tags.py STAT_KEYS)
        self.tag_stats: dict = {}
        # tag payload decoder (ml/tagwork.py = pretrained_tagwork):
        # loaded from tags_model_path when configured, else tags keep
        # their detection-order ids and stay matchable but undecoded
        self.tag_decoder = None
        if settings["tags_recognize"]:
            from ..ml.tagwork import tag_decoder_from_settings

            self.tag_decoder = tag_decoder_from_settings(settings,
                                                         device=device)

    # ------------------------------------------------------------------
    def preprocess_frame(self, frame_index: int, blobs: list[TrackBlob],
                         time: float, timestamp: int = 0) -> PPFrame:
        """Prefilter raw blobs into a PPFrame
        (Tracker::preprocess_frame, Tracker.cpp:633-674)."""
        res: PrefilterResult = prefilter(
            frame_index, blobs, self.background, self.settings)
        pp = PPFrame(index=frame_index, time=time, timestamp=timestamp)
        pp.blobs = res.filtered
        pp.noise = [b for b, _ in res.filtered_out]
        pp.big = res.big_blobs
        return pp

    # ------------------------------------------------------------------
    def _active_individuals(self) -> list[Individual]:
        out = []
        for fid in sorted(self.active):
            ind = self.individuals[fid]
            if not ind.empty():
                out.append(ind)
        return out

    def _new_individual(self) -> Individual:
        ind = Individual(self._next_id, self.settings)
        self.individuals[self._next_id] = ind
        self.active.add(self._next_id)
        self._next_id += 1
        return ind

    def _current_category(self, ind: Individual, s, store) -> int:
        """Majority category of the blobs this fish owned over its last
        2*frame_rate frames (IndividualCache::current_category,
        Individual.cpp:1859-1978); -1 when unlabeled."""
        prev = ind.end_frame
        if prev is None or ind.empty():
            return -1
        fr = int(s["frame_rate"] or 25)
        counts: dict[int, int] = {}
        for f in range(max(ind.start_frame, prev - 2 * fr), prev + 1):
            b = ind.basic_stuff(f)
            if b is None:
                continue
            lbl = store.blob_label(f, b.blob.blob_id)
            if lbl is not None:
                counts[lbl] = counts.get(lbl, 0) + 1
        if not counts:
            return -1
        return max(counts.items(), key=lambda kv: kv[1])[0]

    # ------------------------------------------------------------------
    def add(self, pp: PPFrame) -> MatchResult:
        t0 = _time.perf_counter()
        s = self.settings
        frame = pp.index
        if self.start_frame < 0:
            self.start_frame = frame
        self.frame_times[frame] = pp.time

        # --- caches first (PPFrame::init_cache order): the history split
        # maps fish ESTIMATED positions onto blobs. Computed vectorized
        # over all individuals (track/cache_batch.py).
        active = self._active_individuals()
        caches: dict[int, IndividualCache] = compute_caches(
            active, frame, pp.time, self.frame_times, self.start_frame,
            s)

        frame_rate = float(s["frame_rate"] or 25)
        recent_limit = frame - frame_rate * s["track_max_reassign_time"]
        fish_positions = [
            caches[ind.identity].estimated_px for ind in active
            if not caches[ind.identity].individual_empty
            and ind.end_frame >= recent_limit
        ]
        noise_sink: list = []
        max_ind = int(s["track_max_individuals"])

        blobs = list(pp.blobs)
        if pp.big:
            if frame == self.start_frame:
                # split_big at the start frame (Tracker.cpp prefilter tail):
                # split by expected count = remaining identity budget
                fish_size = SizeFilters(s["track_size_filter"])
                cm = s["cm_per_pixel"] or 1.0
                for b in pp.big:
                    want = 2
                    if fish_size:
                        mid = sum(fish_size.max_range) / 2 or 1.0
                        want = max(2, int(round(
                            b.recount(-1) / mid)) if mid else 2)
                    # the size heuristic over-estimates for touching fish;
                    # retry with fewer expected parts until a split works
                    parts = []
                    while want >= 2 and not parts:
                        parts = split_blob(b, want, self.background, s)
                        want -= 1
                    kept = False
                    for p in parts:
                        sz = p.num_pixels * cm * cm
                        if fish_size.in_range_of_one(sz):
                            p.recount(int(s["track_threshold"]),
                                      self.background, s)
                            blobs.append(p)
                            kept = True
                        else:
                            noise_sink.append(p)
                    if not kept and not parts:
                        noise_sink.append(b)
            else:
                blobs.extend(pp.big)

        if frame != self.start_frame and s["track_do_history_split"]:
            blobs = self._history_split.apply(
                frame, blobs, fish_positions, self.background, noise_sink)
        pp.noise.extend(noise_sink)
        pp.blobs = blobs

        # --- caches + probabilities ------------------------------------------
        # vectorized S*T probability matrix over (fish x blob) — the
        # reference's calculate_paired_probabilities (Tracker.cpp:1083-1360)
        # computed per-edge; the math is identical (see
        # Individual.position_probability), evaluated as one (F,B) array op.
        paired = PairedProbabilities()
        p_min = s["match_min_probability"]
        topk = s["match_topk"]
        cm_per_pixel = s["cm_per_pixel"] or 1.0
        # track_max_speed defaults to 0 (unset); treat as "no speed
        # limit" rather than dividing by zero
        max_speed = s["track_max_speed"] or 1e9
        t_max = s["track_max_reassign_time"]
        # the first pass covers the ACTIVE set only: fish assigned less
        # than track_max_reassign_time ago (IndividualManager ctor
        # prunes at >= t_max; those fish go to the reactivation pass)
        usable = []
        for ind in active:
            cache = caches[ind.identity]
            if (not cache.individual_empty and cache.time_probability > 0
                    and cache.fish_tdelta < t_max):
                usable.append((ind, cache))
        if usable and blobs:
            centers = np.array([b.bbox_center for b in blobs], np.float64)
            est = np.array([c.estimated_px for _, c in usable], np.float64)
            # distance from estimate over ONE frame-time (the global
            # local_tdelta, Individual.cpp:1753/2125) — same divisor
            # for every fish regardless of how long it has been unseen
            tdelta = np.array([c.local_tdelta for _, c in usable])
            tprob = np.array([c.time_probability for _, c in usable])
            d = np.hypot(centers[None, :, 0] - est[:, None, 0],
                         centers[None, :, 1] - est[:, None, 1])
            with np.errstate(divide="ignore", invalid="ignore"):
                speed = np.where(tdelta[:, None] != 0,
                                 d / tdelta[:, None], 0.0) \
                    * (cm_per_pixel / max_speed)
            P = tprob[:, None] / (1.0 + speed) ** 2
            # rare manual/no-history fish use the scalar path (angle term)
            for fi, (ind, cache) in enumerate(usable):
                if cache.valid_frame:
                    for bi, blob in enumerate(blobs):
                        P[fi, bi] = ind.probability(cache, blob.bbox_center)
            # category veto (track_consistent_categories,
            # Individual.cpp:2210-2218 / Tracker.cpp:1126-1134): a fish
            # whose recent blobs carry category L cannot match a blob
            # labeled L' != L. Blob labels come from the Categorize
            # DataStore's per-blob index (applied labels or -load).
            store = getattr(self, "category_store", None)
            if store is not None and s["track_consistent_categories"]:
                blob_lbl = np.array(
                    [(-1 if (l := store.blob_label(
                        frame, b.blob_id)) is None else l)
                     for b in blobs], np.int64)
                if (blob_lbl >= 0).any():
                    fish_lbl = np.array(
                        [self._current_category(ind, s, store)
                         for ind, _ in usable], np.int64)
                    conflict = ((fish_lbl[:, None] >= 0)
                                & (blob_lbl[None, :] >= 0)
                                & (fish_lbl[:, None] != blob_lbl[None, :]))
                    P[conflict] = 0.0
            fi_idx, bi_idx = np.nonzero(P > p_min)
            if topk:
                k = int(topk)
                for fi in np.unique(fi_idx):
                    sel = bi_idx[fi_idx == fi]
                    if len(sel) > k:
                        order = np.argsort(-P[fi, sel])
                        drop = sel[order[k:]]
                        P[fi, drop] = 0.0
                fi_idx, bi_idx = np.nonzero(P > p_min)
            for fi, bi in zip(fi_idx.tolist(), bi_idx.tolist()):
                paired.add(usable[fi][0].identity, bi, float(P[fi, bi]))

        # --- manual matches ---------------------------------------------------
        assigned_fish: set[int] = set()
        assigned_blobs: set[int] = set()
        manual = self.manual_matches.get(frame) or self.manual_matches.get(
            str(frame)) or {}
        blob_by_bid = {b.blob_id: i for i, b in enumerate(blobs)}
        for fid_str, bid in manual.items():
            fid = int(fid_str)
            bi = blob_by_bid.get(bid)
            if bi is None or bi in assigned_blobs:
                continue
            cap = int(s["track_max_individuals"] or 0)
            if cap and fid >= max(cap, self._next_id) + 1024:
                # a runaway manual id (typo/generated) must not allocate
                # millions of individuals
                print(f"[warn] manual match id {fid} far beyond "
                      f"track_max_individuals ({cap}); ignored",
                      file=sys.stderr)
                continue
            while fid >= self._next_id:
                self._new_individual()
            ind = self.individuals[fid]
            if ind.has(frame):
                continue
            ind.add(frame, pp.time, blobs[bi], prob=1.0, manual=True)
            assigned_fish.add(fid)
            assigned_blobs.add(bi)

        # --- matching ---------------------------------------------------------
        result = match(paired, mode=s["match_mode"])
        for bi, fid in sorted(result.pairings.items()):
            if bi in assigned_blobs or fid in assigned_fish:
                continue
            self.individuals[fid].add(frame, pp.time, blobs[bi],
                                      prob=paired.probability(
                                          paired._fish_index[fid],
                                          paired._blob_index[bi]))
            assigned_fish.add(fid)
            assigned_blobs.add(bi)

        # --- second pass: unassigned blobs -> inactive/new individuals --------
        free_blobs = [bi for bi in range(len(blobs))
                      if bi not in assigned_blobs]
        if free_blobs:
            # reactivation (Tracker.cpp:1846-1975): only INACTIVE fish
            # take part — fish whose last assignment is at least
            # track_max_reassign_time old, plus never-assigned ones. A
            # recently-seen fish that merely lost the matching stays
            # active-but-unassigned and cannot grab a leftover blob.
            # p = p_min + (1/sqdist/local_tdelta)*(1-p_min) with the
            # GLOBAL one-frame local_tdelta -> ranking by pure distance;
            # empty fish bid p_min.
            inactive = []
            for ind in self.individuals.values():
                if ind.identity in assigned_fish or ind.has(frame):
                    continue
                if ind.empty():
                    inactive.append(ind)
                    continue
                cache = caches.get(ind.identity) or ind.cache_for_frame(
                    frame, pp.time, self.frame_times, self.start_frame)
                if cache.fish_tdelta >= t_max:
                    inactive.append(ind)
            second = PairedProbabilities()
            for ind in inactive:
                if ind.empty():
                    for bi in free_blobs:
                        second.add(ind.identity,
                                   (blobs[bi].blob_id, bi), p_min)
                    continue
                cache = caches.get(ind.identity) or ind.cache_for_frame(
                    frame, pp.time, self.frame_times, self.start_frame)
                lx, ly = cache.last_seen_px
                tdelta = cache.local_tdelta
                for bi in free_blobs:
                    cx, cy = blobs[bi].center
                    sqdist = (cx - lx) ** 2 + (cy - ly) ** 2
                    if tdelta <= 0:
                        p = 1.0
                    elif sqdist > 0:
                        p = 1.0 / sqdist / tdelta
                    else:
                        p = 1.0 / tdelta
                    # blob keys carry (bid, index); greedy iteration
                    # follows insertion order — the reference's own
                    # second-pass map is a robin_hood UNORDERED map
                    # (PairingGraph.h:172), so no deterministic
                    # reference order exists to replicate
                    second.add(ind.identity,
                               (blobs[bi].blob_id, bi),
                               p_min + p * (1.0 - p_min))
            mode2 = "approximate" if s["match_mode"] == "automatic" \
                else s["match_mode"]
            res2 = match(second, mode=mode2)
            for (bid_key, bi), fid in sorted(res2.pairings.items()):
                if bi in assigned_blobs:
                    continue
                self.individuals[fid].add(frame, pp.time, blobs[bi])
                assigned_fish.add(fid)
                assigned_blobs.add(bi)
            # create brand-new individuals while under the cap
            for bi in free_blobs:
                if bi in assigned_blobs:
                    continue
                if max_ind and len(self.individuals) >= max_ind:
                    break
                ind = self._new_individual()
                ind.add(frame, pp.time, blobs[bi])
                assigned_blobs.add(bi)

        self.end_frame = frame
        # tags_enable turns the (beta) tag DETECTION on; tags_recognize
        # additionally decodes payloads (grabber default_config)
        if (s["tags_recognize"] or s["tags_enable"]) and pp.noise:
            from .tags import detect_tags, match_tags_to_fish

            tags = detect_tags(pp.noise, self.background, frame,
                               decode_fn=self.tag_decoder,
                               settings=s, stats=self.tag_stats)
            if tags:
                matched = match_tags_to_fish(tags, self, frame)
                if matched:
                    self.tag_assignments[frame] = {
                        fid: t.tag_id for fid, t in matched.items()}
                    self.tag_assignment_p[frame] = {
                        fid: t.p for fid, t in matched.items()}
                    for fid, t in matched.items():
                        self.detected_tags.setdefault(fid, []).append(t)

        st = FrameStatistics(
            number_fish=len(assigned_fish),
            adding_seconds=_time.perf_counter() - t0,
            match_improvements=result.improvements_made,
        )
        self.statistics[frame] = st
        return result

    # ------------------------------------------------------------------
    def emergency_finish(self):
        """Drop transient state; history stays valid (Tracker.h:265)."""
        return

    def average_seconds_per_individual(self) -> float:
        tot_fish = sum(s.number_fish for s in self.statistics.values())
        tot_t = sum(s.adding_seconds for s in self.statistics.values())
        return tot_t / tot_fish if tot_fish else 0.0
