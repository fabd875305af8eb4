"""FastTracker: the struct-of-arrays host tracking engine.

Counterpart of ``trex_tpu/track/engine.py::FastTracker`` for the
configurations the device engine replays through: every ``match_mode``
but ``benchmark`` (``approximate``, ``hungarian``, ``tree`` and the
product default ``automatic``), with or without the history split, speed
decay, posture and archive mode. It keeps all per-fish state in flat
numpy arrays. ``automatic`` takes the
native phases of ``native/tracker_core.cpp`` (caches, paired
probabilities with per-clique matching, reactivation) and the native
split executor, as the JAX package's engine does; the other modes take
the Python paths. Host code stays numpy, as it is there. With
``calculate_posture`` every assignment of a frame gets its posture from
one call of the native batch chain (``track/posture.py``), the previous
midline direction of each fish orienting the next. With
``track_speed_decay < 1`` the matching distances and the history split
measure from the decay extrapolation over a per-fish motion window
(``track/cache_batch.py``). With ``keep_individuals`` (archive mode) each
frame's assignments are kept as lean blobs with their posture records,
and ``individuals`` replays them into per-identity archives
(``track/archive.py``).

Per frame (``add_frame``): candidate table from the labeler's flat
arrays (Tracker::prefilter, with the track-threshold re-split of
partially passing blobs), the start-frame split of oversized blobs, the
history split of blobs that more tracked fish expect than they hold
(HistorySplit), the time probability from recent samples, the first
pass (probability matrix over bbox centres, matching by ``match_mode``),
then the second pass (reactivation of inactive fish against centroids,
then new fish in blob order while under ``track_max_individuals``),
then posture.

Posture closing steps raise ``EngineUnsupported`` in the constructor,
as in the JAX package: the object Tracker (``track/tracker.py``) takes
them.
"""
from __future__ import annotations

import ctypes
import time as _time
from dataclasses import dataclass

import numpy as np

from ..config import SettingsView
from ..ops.labeling import (SplitExecutor, _f64p, _i32p, _i64p, _lib,
                            blob_stats, expectation_native)
from .blob import TrackBlob
from .cache_batch import window_estimate_scalar, window_motion
from .individual import CACHE_WINDOW
from .matching import MatchResult, PairedProbabilities, match
from .prefilter import SizeFilters, threshold_components
from .archive import build_individuals, compute_posture_rows
from .posture import _get_native_posture
from .splitting import _initial_threshold, split_blob
from .tracker import FrameStatistics


class EngineUnsupported(ValueError):
    """The settings need an engine or a slice the port lacks."""


def check_supported(settings) -> None:
    s = SettingsView(settings)

    def want(cond, why):
        if not cond:
            raise EngineUnsupported(why)
    want(not (s["manual_matches"] or {}), "manual_matches")
    want(not (s["manual_splits"] or {}), "manual_splits")
    want(not (s["track_ignore"] or []), "track_ignore")
    want(not (s["track_include"] or []), "track_include")
    want(not (s["track_ignore_bdx"] or {}), "track_ignore_bdx")
    want(int(s["track_threshold"]) > 0, "track_threshold == 0")
    want(int(s["track_threshold_2"]) <= 0, "track_threshold_2")
    want(bool(s["track_background_subtraction"]),
         "track_background_subtraction off")
    want(not int(s["match_topk"] or 0), "match_topk")
    want(int(s["track_max_individuals"]) > 0, "unbounded individuals")
    want(s["match_mode"] in ("automatic", "approximate", "hungarian",
                             "tree"),
         f"match_mode {s['match_mode']!r} (benchmark needs the object "
         "tracker)")
    want(not (s["track_only_categories"] or []), "track_only_categories")
    want(not s["track_consistent_categories"],
         "track_consistent_categories")
    want(not s["closed_loop_enable"], "closed_loop_enable")
    want(not s["tags_recognize"], "tags_recognize")
    for flag in ("auto_train", "auto_apply", "auto_categorize",
                 "auto_tags"):
        want(not s[flag], flag)
    # later slices of the port (ROADMAP.md)
    if s["calculate_posture"]:
        # the native batch chain covers the closing-free configuration
        want(int(s["posture_closing_steps"]) == 0,
             "posture_closing_steps (the posture-closing chain is the "
             "object Tracker's: track_engine=object)")


@dataclass
class _CandTable:
    """Per-frame candidate blobs as flat arrays. Rows are backed either
    by slices into the frame's native line/pixel arrays or by a
    TrackBlob (re-split children and split pieces)."""
    n: int
    cnt: np.ndarray        # num_pixels
    recount: np.ndarray    # cm^2 at track_threshold
    cx: np.ndarray         # mask centroid
    cy: np.ndarray
    bx0: np.ndarray
    by0: np.ndarray
    bx1: np.ndarray
    by1: np.ndarray
    line_lo: np.ndarray    # [lo, hi) into `lines`; -1 when object-backed
    line_hi: np.ndarray
    objs: list             # TrackBlob or None per row
    lines: np.ndarray      # frame line array (L, 3)
    pixel_lo: np.ndarray   # per row, offset into pixels; -1 if object
    pixel_hi: np.ndarray
    pixels: np.ndarray
    # the row of the frame's stats array (-1 for object-backed rows);
    # archive mode reads the orientation moments from it
    srow: np.ndarray = None

    def blob(self, i: int) -> TrackBlob:
        """Row i as a TrackBlob (the split path)."""
        if self.objs[i] is not None:
            return self.objs[i]
        lines = self.lines[self.line_lo[i]:self.line_hi[i]]
        px = self.pixels[self.pixel_lo[i]:self.pixel_hi[i]] \
            if self.pixel_lo[i] >= 0 else None
        return TrackBlob(lines, px)


def _in_range_rows(values: np.ndarray, ranges) -> np.ndarray:
    if not ranges:
        return np.ones(values.shape, bool)
    out = np.zeros(values.shape, bool)
    for lo, hi in ranges:
        out |= (values >= lo) & (values <= hi)
    return out


class FastTracker:
    def __init__(self, settings, background: np.ndarray,
                 keep_individuals: bool = False):
        check_supported(settings)
        s = self.settings = SettingsView(settings)
        self.background = background
        # archive mode: each frame's assigned blobs (lean TrackBlobs) and
        # full posture geometry are recorded, and build_individuals
        # (track/archive.py) replays them into per-identity Individuals,
        # the store the export surfaces read. Off by default: the
        # throughput path keeps positional history only.
        self.archive_mode = bool(keep_individuals)
        self.frame_archive: dict[int, tuple] = {}
        self.posture_archive: dict[int, list] = {}
        self._individuals_cache = None
        self._cur_stats = None
        self._cur_preds = None
        self.F = int(s["track_max_individuals"])
        F = self.F
        self.cm = float(s["cm_per_pixel"] or 1.0)
        self.cm_sqr = self.cm * self.cm
        self.frame_rate = int(s["frame_rate"] or 25)
        self.t_max = float(s["track_max_reassign_time"])
        self.p_min = float(s["match_min_probability"])
        self.max_speed = float(s["track_max_speed"] or 1e9)
        self.fish_size = SizeFilters(s["track_size_filter"])
        self.track_thr = int(s["track_threshold"])
        self.absolute = bool(s["track_threshold_is_absolute"])
        self.mode = s["match_mode"]
        self.minimum_frames = min(self.frame_rate, 5)
        self.time_prob_enabled = bool(s["track_time_probability_enabled"])
        self.punish_td = bool(s["tracklet_punish_timedelta"])
        self.punish_sp = bool(s["tracklet_punish_speeding"])
        self.trk_max_len = float(s["tracklet_max_length"] or 0)
        self.max_gap = float(s["track_max_reassign_time"])

        self.n_fish = 0                     # created so far
        self.last_frame = np.full(F, -(10 ** 9), np.int64)
        self.start_frame_f = np.full(F, -1, np.int64)
        self.last_x = np.zeros(F)
        self.last_y = np.zeros(F)
        self.last_time = np.zeros(F)
        self.n_basic = np.zeros(F, np.int64)
        # current tracklet + the end of the one before it
        self.trk_start = np.full(F, -1, np.int64)
        self.trk_start_time = np.zeros(F)
        self.prev_trk_end = np.full(F, -(10 ** 9), np.int64)
        self.closed_tracklets: list[list[list[int]]] = [
            [] for _ in range(F)]
        # ring of the latest closed tracklets for the native recent-
        # samples walk: only tracklets that reach into the last
        # ~frame_rate frames matter, and each spans >= 2 frames with its
        # gap
        self.RING = 16
        self.trk_ring = np.zeros((F, self.RING, 2), np.int64)
        self.trk_ring_n = np.zeros(F, np.int32)
        # the native phases have automatic matching's semantics
        self.use_native = self.mode == "automatic"
        self._split_executor = None  # SplitExecutor, made at first use
        # track_speed_decay < 1: the matching distances measure from the
        # decay-weighted velocity extrapolation instead of the last
        # position (Individual.cpp:1995-2025), over a per-fish motion
        # window (the flat-array twin of Individual._win) that exists
        # only when the decay is active
        decay = min(1.0, max(0.0, float(s["track_speed_decay"])))
        self.decay_active = decay ** 4 < 1.0
        if self.decay_active:
            self.win = np.full((F, CACHE_WINDOW, 4), np.nan)
            self.win[:, :, 0] = -1e9

        self.start_frame = -1
        self.end_frame = -1
        self.frame_times: dict[int, float] = {}
        self.statistics: dict[int, FrameStatistics] = {}
        # per frame: fish ids, x, y, prob
        self.history: dict[int, dict] = {}
        # batched native posture: per frame {fish, ok, midline_length,
        # angle}, and per fish the last midline direction for the next
        # frame's orientation
        self.do_posture = bool(s["calculate_posture"])
        self.posture_history: dict[int, dict] = {}
        self._posture_dir = np.zeros((F, 2))
        if self.do_posture:
            try:
                _get_native_posture()
            except (OSError, AttributeError) as e:
                raise EngineUnsupported(
                    f"posture needs the native batch chain: {e}")

    # -- candidate construction (Tracker::prefilter) --------------------
    def build_candidates(self, lines: np.ndarray, pixels: np.ndarray,
                         line_start: np.ndarray, pixel_start: np.ndarray,
                         stats: np.ndarray) -> tuple[_CandTable, list]:
        """Vectorized prefilter over the native labeler's raw arrays.
        Returns (candidate table incl. big blobs, big row indices)."""
        s = self.settings
        N = len(stats)
        if N == 0:
            empty = np.zeros(0)
            none = np.zeros(0, np.int64)
            return _CandTable(0, empty, empty, empty, empty, empty, empty,
                              empty, empty, none, none, [], lines, none,
                              none, pixels, srow=none), []
        rows = np.arange(N)
        count = stats[:, 0]
        track_count = stats[:, 1]
        size_px = count * self.cm_sqr
        max_lo, max_hi = self.fish_size.max_range
        # huge blobs skip the expensive recount (force_set_recount)
        huge = bool(self.fish_size) & (size_px > max_hi * 100)
        recount = np.where(huge, size_px, track_count * self.cm_sqr)
        # all-passing blobs keep their row: the threshold_components fast
        # path yields a child identical to its parent with the same
        # recount, so only partially passing blobs need the re-split
        close = (not self.fish_size) | _in_close(recount, self.fish_size)
        slow = close & (track_count != count) & (track_count > 0) & ~huge

        if not slow.any():
            table = self._table_from_rows(rows, count, recount, lines,
                                          pixels, line_start, pixel_start,
                                          stats)
        else:
            idx_rows: list = []
            cnt_l: list = []
            rec_l: list = []
            objs: list = []
            for i in range(N):
                if slow[i]:
                    b = TrackBlob(
                        lines[line_start[i]:line_start[i + 1]],
                        pixels[pixel_start[i]:pixel_start[i + 1]],
                        stats=stats[i])
                    comps = threshold_components(
                        b, self.track_thr, self.background, s)
                    if comps:
                        for c in comps:
                            c.recount(self.track_thr, self.background, s)
                            idx_rows.append(-1)
                            cnt_l.append(c.num_pixels)
                            rec_l.append(c.recount(-1))
                            objs.append(c)
                        continue
                idx_rows.append(i)
                cnt_l.append(count[i])
                rec_l.append(recount[i])
                objs.append(None)
            table = self._table_mixed(idx_rows, cnt_l, rec_l, objs, lines,
                                      pixels, line_start, pixel_start,
                                      stats)

        # classification (filtered / noise / big)
        in_rng = _in_range_rows(table.recount, self.fish_size.ranges)
        small = np.zeros(table.n, bool)
        if self.fish_size:
            small = ~in_rng & (table.recount < max_lo)
        keep = in_rng | ~small
        big_mask = ~in_rng & ~small
        table = _filter_table(table, keep)
        return table, np.flatnonzero(big_mask[keep]).tolist()

    def _table_from_rows(self, rows, cnt, rec, lines, pixels, line_start,
                         pixel_start, stats) -> _CandTable:
        st = stats[rows]
        n = st[:, 0]
        lo = line_start[rows].astype(np.int64)
        hi = line_start[rows + 1].astype(np.int64)
        y0 = lines[lo, 0].astype(np.float64)
        y1 = lines[np.maximum(hi - 1, lo), 0].astype(np.float64)
        # x bounds packed by the native labeler (st[7] = x0*65536 + x1)
        allx0 = np.floor(st[:, 7] / 65536.0)
        allx1 = st[:, 7] - allx0 * 65536.0
        return _CandTable(
            n=len(rows), cnt=np.asarray(cnt, np.float64),
            recount=np.asarray(rec, np.float64),
            cx=st[:, 2] / n, cy=st[:, 3] / n,
            bx0=allx0, by0=y0, bx1=allx1, by1=y1,
            line_lo=lo, line_hi=hi,
            objs=[None] * len(rows), lines=lines,
            pixel_lo=pixel_start[rows].astype(np.int64),
            pixel_hi=pixel_start[rows + 1].astype(np.int64),
            pixels=pixels, srow=np.asarray(rows, np.int64))

    def _table_mixed(self, idx_rows, cnt_l, rec_l, objs, lines, pixels,
                     line_start, pixel_start, stats) -> _CandTable:
        n = len(idx_rows)
        cx, cy, bx0, by0, bx1, by1 = (np.zeros(n) for _ in range(6))
        lo, hi, plo, phi = (np.full(n, -1, np.int64) for _ in range(4))
        for r, i in enumerate(idx_rows):
            if i >= 0:
                lo[r] = line_start[i]
                hi[r] = line_start[i + 1]
                plo[r] = pixel_start[i]
                phi[r] = pixel_start[i + 1]
                st = stats[i]
                cx[r] = st[2] / st[0]
                cy[r] = st[3] / st[0]
                ls = lines[lo[r]:hi[r]]
                bx0[r] = ls[:, 1].min()
                bx1[r] = ls[:, 2].max()
                by0[r] = ls[0, 0]
                by1[r] = ls[-1, 0]
            else:
                b = objs[r]
                cx[r], cy[r] = b.center
                x, y, w, h = b.bounds
                bx0[r], by0[r] = x, y
                bx1[r], by1[r] = x + w - 1, y + h - 1
        return _CandTable(n, np.asarray(cnt_l, np.float64),
                          np.asarray(rec_l, np.float64), cx, cy, bx0, by0,
                          bx1, by1, lo, hi, objs, lines, plo, phi, pixels,
                          srow=np.asarray(idx_rows, np.int64).reshape(-1))

    # -- history split ---------------------------------------------------
    def _grid_points(self, table: _CandTable, rows: np.ndarray):
        """Sampled mask points of the given rows (PPFrame::
        fill_proximity_grid: first, last and even-y lines, all lines
        below 4; per line both ends, the middle and interior points every
        floor(max(1, width * 0.1)) px when that step is >= 5) in one pass
        over the rows' lines. Returns (points (N, 2), row slot (N,))."""
        line_arrays = [
            np.asarray(table.objs[r].lines)
            if table.objs[r] is not None
            else table.lines[table.line_lo[r]:table.line_hi[r]]
            for r in rows.tolist()]
        counts = np.fromiter((len(a) for a in line_arrays), np.int64,
                             len(line_arrays))
        L = np.concatenate(line_arrays).astype(np.float64)
        ends = np.cumsum(counts)
        starts = ends - counts
        line_owner = np.repeat(np.arange(len(counts)), counts)
        keep = L[:, 0] % 2 == 0
        keep[np.repeat(counts < 4, counts)] = True
        keep[starts] = True
        keep[ends - 1] = True
        Lk = L[keep]
        ok_owner = line_owner[keep]
        y = Lk[:, 0]
        x0 = Lk[:, 1]
        x1 = Lk[:, 2]
        pts = np.concatenate([
            np.stack([x0, y], 1), np.stack([x1, y], 1),
            np.stack([x0 + (x1 - x0) * 0.5, y], 1)])
        owner = np.concatenate([ok_owner] * 3)
        steps = np.maximum(
            1.0, (table.bx1[rows] - table.bx0[rows] + 1) * 0.1
        ).astype(np.int64)
        step_of = steps[ok_owner]
        wide = np.flatnonzero((step_of >= 5) & (x1 - x0 >= 2 * step_of))
        if wide.size:
            extra = []
            extra_owner = []
            for i in wide.tolist():
                st = step_of[i]
                xs = np.arange(x0[i] + st, x1[i] - st + 1e-9, st)
                extra.append(np.stack([xs, np.full(xs.size, y[i])], 1))
                extra_owner.append(np.full(xs.size, ok_owner[i], np.int64))
            pts = np.concatenate([pts] + extra)
            owner = np.concatenate([owner] + extra_owner)
        return pts, owner

    def _split_expectation(self, table: _CandTable, fish_pos: np.ndarray,
                           max_d: float) -> dict[int, int]:
        """HistorySplit expectation {row: pieces} over the table, in the
        native ``trex_expectation`` (``_split_expectation_py`` is its
        numpy twin)."""
        if not len(fish_pos) or not table.n:
            return {}
        lines = table.lines
        row_lo = table.line_lo
        row_hi = table.line_hi
        if any(o is not None for o in table.objs):
            # object-backed rows (re-split children, split pieces): their
            # lines go into a side buffer that their ranges point at
            extra = [np.asarray(o.lines, np.int32)
                     for o in table.objs if o is not None]
            off = len(lines)
            lines = np.concatenate([lines] + extra)
            row_lo = row_lo.copy()
            row_hi = row_hi.copy()
            for i, o in enumerate(table.objs):
                if o is not None:
                    row_lo[i] = off
                    row_hi[i] = off + len(o.lines)
                    off += len(o.lines)
        bounds = np.stack([table.bx0, table.by0, table.bx1, table.by1],
                          axis=1)
        expect = expectation_native(fish_pos, lines, row_lo, row_hi,
                                    bounds, max_d)
        return {int(b): int(expect[b]) for b in np.flatnonzero(expect)}

    def _expectation_prefilter(self, table: _CandTable,
                               fish_pos: np.ndarray, max_d: float):
        """Bbox proximity: None when no blob has two near fish, else
        (near (fish, blob) of the involved fish, blobs near them, the
        involved fish)."""
        if not len(fish_pos) or not table.n:
            return None
        fx = fish_pos[:, 0][:, None]
        fy = fish_pos[:, 1][:, None]
        dx = np.maximum(0, np.maximum(table.bx0[None, :] - fx,
                                      fx - table.bx1[None, :]))
        dy = np.maximum(0, np.maximum(table.by0[None, :] - fy,
                                      fy - table.by1[None, :]))
        near = np.hypot(dx, dy) <= max_d
        contested = near.sum(axis=0) >= 2
        if not contested.any():
            return None
        involved = near[:, contested].any(axis=1)
        fish_ids = np.flatnonzero(involved)
        cand = near[involved]
        return cand, np.flatnonzero(cand.any(axis=0)), fish_ids

    def _split_expectation_py(self, table: _CandTable,
                              fish_pos: np.ndarray,
                              max_d: float) -> dict[int, int]:
        """Numpy twin of ``_split_expectation``."""
        pre = self._expectation_prefilter(table, fish_pos, max_d)
        if pre is None:
            return {}
        cand, cand_blobs, fish_ids = pre
        pts, owner = self._grid_points(table, cand_blobs)
        fpos = fish_pos[fish_ids]
        d2 = (pts[None, :, 0] - fpos[:, 0, None]) ** 2 \
            + (pts[None, :, 1] - fpos[:, 1, None]) ** 2
        md2 = np.full((len(fish_ids), len(cand_blobs)), np.inf)
        np.minimum.at(md2, (slice(None), owner), d2)
        md = np.sqrt(md2)
        slot_of = {int(b): si for si, b in enumerate(cand_blobs)}
        edges: dict[int, list] = {}
        fr_rows, bi_cols = np.nonzero(cand)
        for fr, bi in zip(fr_rows.tolist(), bi_cols.tolist()):
            dist = md[fr, slot_of[bi]]
            if dist <= max_d:
                edges.setdefault(int(fish_ids[fr]), []).append(
                    (float(dist), bi))
        for es in edges.values():
            es.sort()
        return _resolve_expectation(edges)

    def _apply_history_split(self, table: _CandTable,
                             fish_pos: np.ndarray) -> _CandTable:
        """Split the blobs the expectation names, then apply the final
        size filter (HistorySplit.cpp:364-373)."""
        s = self.settings
        # the radius reads the raw track_max_speed like HistorySplit: 0
        # means no history split (self.max_speed's 1e9 stand-in is for
        # the matching distance only)
        max_d = (float(s["track_max_speed"]) / self.cm) \
            / max(1.0, float(self.frame_rate)) * 0.5
        expect = self._split_expectation(table, fish_pos, max_d)
        drop = np.zeros(table.n, bool)
        insert: dict[int, list] = {}
        # table-backed native jobs go in one batched call; `insert` keeps
        # the expectation's order either way. Archive mode keeps the
        # split_blob pieces (TrackBlobs with lines and flags, which the
        # archives need; the native executor's _StatPieces carry stats
        # only)
        batch_ok = (self.use_native and not self.archive_mode
                    and s["blob_split_algorithm"] != "none")
        jobs: list[tuple[int, int]] = []
        for bi, want in expect.items():
            if want < 2:
                continue
            drop[bi] = True
            if batch_ok and table.objs[bi] is None \
                    and table.pixel_lo[bi] >= 0:
                jobs.append((bi, want))
                insert[bi] = []  # placeholder keeps the dict order
                continue
            if self.use_native and not self.archive_mode:
                parts = self._split_native(table, bi, want)
            else:
                parts = split_blob(table.blob(bi), want, self.background, s)
                for p in parts:
                    p.recount(self.track_thr, self.background, s)
            if parts:
                insert[bi] = parts
        if jobs:
            for (bi, _), parts in zip(jobs,
                                      self._split_native_batch(table, jobs)):
                if parts:
                    insert[bi] = parts
                else:
                    del insert[bi]
        if not drop.any():
            keep = _in_range_rows(table.recount, self.fish_size.ranges) \
                if self.fish_size else np.ones(table.n, bool)
            return _filter_table(table, keep)
        return _rebuild_with_splits(table, drop, insert, self.fish_size,
                                    self.cm_sqr)

    def _executor(self) -> SplitExecutor:
        if self._split_executor is None:
            self._split_executor = SplitExecutor(self.background,
                                                 self.fish_size.ranges)
        return self._split_executor

    def _split_args(self):
        s = self.settings
        return (_initial_threshold(s), self.absolute, self.cm_sqr,
                float(s["blob_split_max_shrink"]),
                float(s["blob_split_global_shrink_limit"]))

    def _split_native_batch(self, table: _CandTable, jobs: list) -> list:
        """Every table-backed split of a frame in one native call: one
        _StatPiece list per (row, want) job, equal to _split_native's."""
        bis = np.array([b for b, _ in jobs], np.int64)
        initial, absolute, cm_sqr, shrink, limit = self._split_args()
        rows = self._executor().run_batch(
            table.lines, table.pixels, table.line_lo[bis],
            table.line_hi[bis], table.pixel_lo[bis],
            np.array([w for _, w in jobs], np.int32), initial, absolute,
            cm_sqr, shrink, limit)
        return [[_StatPiece(r, self.cm_sqr) for r in rr] for rr in rows]

    def _split_native(self, table: _CandTable, bi: int,
                      want: int) -> list:
        """Native split of table row bi into stat pieces."""
        if table.objs[bi] is not None:
            lines, pixels = table.objs[bi].lines, table.objs[bi].pixels
        else:
            lines = table.lines[table.line_lo[bi]:table.line_hi[bi]]
            if table.pixel_lo[bi] < 0:
                return []
            pixels = table.pixels[table.pixel_lo[bi]:table.pixel_hi[bi]]
        if pixels is None or self.settings["blob_split_algorithm"] \
                == "none":
            return []
        initial, absolute, cm_sqr, shrink, limit = self._split_args()
        rows = self._executor().run(lines, pixels, initial, absolute, want,
                                    cm_sqr, shrink, limit)
        return [_StatPiece(r, self.cm_sqr) for r in rows]

    # -- caches (track_speed_decay 1: estimate = last position) ---------
    def _caches(self, frame: int, time: float):
        if self.use_native:
            return self._caches_native(frame, time)
        return self._caches_py(frame, time)

    def _caches_native(self, frame: int, time: float):
        F = self.n_fish
        tdelta = np.empty(F)
        tprob = np.empty(F)
        if F:
            _lib().trex_track_caches(
                F, int(frame), float(time), int(self.start_frame),
                self.last_frame.ctypes.data_as(_i64p),
                self.last_time.ctypes.data_as(_f64p),
                self.trk_start.ctypes.data_as(_i64p),
                self.trk_ring.ctypes.data_as(_i64p),
                self.trk_ring_n.ctypes.data_as(_i32p),
                self.RING, self.frame_rate, self.t_max, self.p_min,
                self.minimum_frames, int(self.time_prob_enabled),
                tdelta.ctypes.data_as(_f64p), tprob.ctypes.data_as(_f64p))
        has = self.last_frame[:F] > -(10 ** 8)
        return has, tdelta, tprob

    def _caches_py(self, frame: int, time: float):
        F = self.n_fish
        last_f = self.last_frame[:F]
        has = last_f > -(10 ** 8)
        tdelta = np.maximum(time - self.last_time[:F], 1e-6)
        if not self.time_prob_enabled:
            tprob = np.where(has, 1.0, 0.0)
        else:
            p = 1.0 - np.minimum(1.0, np.maximum(
                0.0, (tdelta - 1.0 / self.frame_rate) / self.t_max))
            scale = np.ones(F)
            needs = has & (last_f >= self.start_frame
                           + self.minimum_frames)
            if needs.any():
                R = self._recent_samples(np.flatnonzero(needs), frame)
                scale[needs] = np.minimum(
                    1.0, (R - 1) / self.minimum_frames + self.p_min)
            tprob = np.where(tdelta > self.t_max, 0.0,
                             (p * scale) * 0.75 + 0.25)
            tprob = np.where(has, tprob, 0.0)
        return has, tdelta, tprob

    def _recent_samples(self, fids: np.ndarray, frame: int) -> np.ndarray:
        """Individual.recent_number_samples vectorized: the current
        tracklet covers the common case; fish whose previous tracklet
        could reach into the window walk their list. The window is
        anchored at the current frame (Individual.cpp:1806)."""
        prev = self.last_frame[fids]
        lower = frame - self.frame_rate
        time_limit = self.frame_rate * self.t_max
        start = self.trk_start[fids]
        n = np.minimum(prev, frame) - np.maximum(start, lower) + 1
        n = np.maximum(n, 0)
        # the walk breaks at once when the gap to the newest tracklet
        # exceeds frame_rate * t_max (Individual.cpp:1802-1838)
        n = np.where(frame - prev > time_limit, 0, n)
        fallback = (start > lower) & (self.prev_trk_end[fids] >= lower) \
            & (start - self.prev_trk_end[fids] <= time_limit)
        for k in np.flatnonzero(fallback).tolist():
            n[k] = self._recent_samples_walk(int(fids[k]), frame)
        return n

    def _recent_samples_walk(self, fid: int, frame: int) -> int:
        lower = frame - self.frame_rate
        time_limit = self.frame_rate * self.t_max
        n = 0
        previous = frame
        trks = self.closed_tracklets[fid] \
            + [[int(self.trk_start[fid]), int(self.last_frame[fid])]]
        for t in reversed(trks):
            if t[1] < lower:
                break
            if previous - t[1] > time_limit:
                break
            start = max(t[0], lower)
            end = min(t[1], frame)
            previous = start
            n += max(0, end - start + 1)
        return n

    # -- assignment bookkeeping (Individual.add) --------------------------
    def _assign(self, fids: np.ndarray, frame: int, time: float,
                xs: np.ndarray, ys: np.ndarray):
        if not len(fids):
            return
        lf = self.last_frame[fids]
        lt = self.last_time[fids]
        nb = self.n_basic[fids]
        fresh = nb == 0
        dt = time - lt
        with np.errstate(invalid="ignore", divide="ignore"):
            speed_cm = np.hypot(xs - self.last_x[fids],
                                ys - self.last_y[fids]) \
                / np.where(dt > 0, dt, np.inf) * self.cm
        ok = (lf == frame - 1) & (nb >= 1)
        if self.punish_td:
            ok &= ~(dt >= self.max_gap)
        if self.punish_sp:
            ok &= ~(speed_cm >= self.max_speed * 0.99)
        if self.trk_max_len > 0:
            ok &= (time - self.trk_start_time[fids]) < self.trk_max_len
        # the very first assignment of a fish also opens a tracklet
        breaks = ~ok
        for k in np.flatnonzero(breaks & ~fresh).tolist():
            fid = int(fids[k])
            ts = int(self.trk_start[fid])
            te = int(self.last_frame[fid])
            self.closed_tracklets[fid].append([ts, te])
            n = int(self.trk_ring_n[fid])
            if n == self.RING:
                self.trk_ring[fid, :-1] = self.trk_ring[fid, 1:]
                n -= 1
            self.trk_ring[fid, n] = (ts, te)
            self.trk_ring_n[fid] = n + 1
        bf = fids[breaks]
        self.prev_trk_end[bf] = np.where(
            fresh[breaks], -(10 ** 9), self.last_frame[bf])
        self.trk_start[bf] = frame
        self.trk_start_time[bf] = time
        self.start_frame_f[fids] = np.where(fresh, frame,
                                            self.start_frame_f[fids])
        self.last_frame[fids] = frame
        self.last_x[fids] = xs
        self.last_y[fids] = ys
        self.last_time[fids] = time
        self.n_basic[fids] += 1
        if self.decay_active:
            self.win[fids, :-1] = self.win[fids, 1:]
            self.win[fids, -1, 0] = frame
            self.win[fids, -1, 1] = xs
            self.win[fids, -1, 2] = ys
            self.win[fids, -1, 3] = time

    def _position_estimates(self, frame: int, time: float):
        """Estimated positions (full F arrays) the matching distances and
        the history split's fish positions measure from: the last
        positions at ``track_speed_decay`` 1, else the decay extrapolation
        over the motion windows (cache_batch.window_motion; fish the
        array math cannot reproduce take window_estimate_scalar)."""
        F = self.n_fish
        if not self.decay_active or F == 0:
            return self.last_x, self.last_y
        m = window_motion(self.win[:F], self.start_frame_f[:F], frame,
                          time, self.frame_times, self.settings)
        est_x = self.last_x.copy()
        est_y = self.last_y.copy()
        est_x[:F] = m["est_x"]
        est_y[:F] = m["est_y"]
        for i in np.flatnonzero(m["need_scalar"]).tolist():
            est_x[i], est_y[i] = window_estimate_scalar(
                self.win[i], int(self.start_frame_f[i]), frame, time,
                self.frame_times, self.settings)
        return est_x, est_y

    # -- matching ---------------------------------------------------------
    def _match_py(self, uf: np.ndarray, tdelta: np.ndarray,
                  tprob: np.ndarray, table: _CandTable, B: int,
                  est_x: np.ndarray, est_y: np.ndarray):
        """Probability matrix over bbox centres + matching."""
        bcx = (table.bx0 + table.bx1 + 1) * 0.5
        bcy = (table.by0 + table.by1 + 1) * 0.5
        d = np.hypot(bcx[None, :] - est_x[uf][:, None],
                     bcy[None, :] - est_y[uf][:, None])
        speed = d / tdelta[uf][:, None] * (self.cm / self.max_speed)
        P = tprob[uf][:, None] / (1.0 + speed) ** 2
        fob = np.full(B, -1, np.int64)
        pob = np.zeros(B)
        fi_idx, bi_idx = np.nonzero(P > self.p_min)
        if not len(fi_idx):
            return fob, pob
        probs = P[fi_idx, bi_idx]
        # isolated 1-edge fish x 1-edge blob pairs are singleton
        # cliques: assign directly; the matcher gets the rest
        f_deg = np.bincount(fi_idx, minlength=len(uf))
        b_deg = np.bincount(bi_idx, minlength=B)
        triv = (f_deg[fi_idx] == 1) & (b_deg[bi_idx] == 1)
        fob[bi_idx[triv]] = uf[fi_idx[triv]]
        pob[bi_idx[triv]] = probs[triv]
        rest = ~triv
        if rest.any():
            paired = _bulk_paired(uf[fi_idx[rest]], bi_idx[rest],
                                  probs[rest])
            result = match(paired, mode=self.mode)
            pmap = {(int(uf[f]), int(b)): float(p) for f, b, p in
                    zip(fi_idx[rest], bi_idx[rest], probs[rest])}
            for bi, fid in result.pairings.items():
                fob[bi] = fid
                pob[bi] = pmap[(fid, bi)]
        return fob, pob

    def _match_native(self, uf: np.ndarray, tdelta: np.ndarray,
                      tprob: np.ndarray, table: _CandTable, B: int,
                      est_x: np.ndarray, est_y: np.ndarray):
        """``trex_track_match``: probabilities, singleton cliques and
        cliques of up to 8 fish natively; the larger cliques come back as
        pending edges for ``match``. On pending-edge overflow the whole
        frame takes ``_match_py``."""
        uf32 = np.ascontiguousarray(uf, np.int32)
        bcx = np.ascontiguousarray((table.bx0 + table.bx1 + 1) * 0.5)
        bcy = np.ascontiguousarray((table.by0 + table.by1 + 1) * 0.5)
        fob32 = np.empty(B, np.int32)
        pob = np.empty(B)
        cap = 65536
        buf = getattr(self, "_pend_buf", None)
        if buf is None:
            buf = self._pend_buf = (np.empty(cap, np.int32),
                                    np.empty(cap, np.int32), np.empty(cap))
        pend_f, pend_b, pend_p = buf
        est_x = np.ascontiguousarray(est_x)
        est_y = np.ascontiguousarray(est_y)
        n_pend = _lib().trex_track_match(
            uf32.ctypes.data_as(_i32p), len(uf32),
            est_x.ctypes.data_as(_f64p), est_y.ctypes.data_as(_f64p),
            tdelta.ctypes.data_as(_f64p), tprob.ctypes.data_as(_f64p),
            bcx.ctypes.data_as(_f64p), bcy.ctypes.data_as(_f64p), B,
            self.p_min, self.cm / self.max_speed, 8,
            fob32.ctypes.data_as(_i32p), pob.ctypes.data_as(_f64p),
            pend_f.ctypes.data_as(_i32p), pend_b.ctypes.data_as(_i32p),
            pend_p.ctypes.data_as(_f64p), len(pend_f))
        if n_pend < 0:  # pending-edge overflow
            return self._match_py(uf, tdelta, tprob, table, B, est_x,
                                  est_y)
        fob = fob32.astype(np.int64)
        if n_pend:
            paired = _bulk_paired(pend_f[:n_pend], pend_b[:n_pend],
                                  pend_p[:n_pend])
            result = match(paired, mode=self.mode)
            pmap = {(int(f), int(b)): float(p) for f, b, p in
                    zip(pend_f[:n_pend], pend_b[:n_pend], pend_p[:n_pend])}
            for bi, fid in result.pairings.items():
                fob[bi] = fid
                pob[bi] = pmap[(fid, bi)]
        return fob, pob

    # -- main ------------------------------------------------------------
    def add_frame(self, frame: int, time: float, lines, pixels,
                  line_start, pixel_start, stats,
                  predictions: list = None) -> MatchResult:
        """Track one frame from the labeler's flat arrays; `predictions`
        (archive mode) are the detector's per-blob pose or outline
        predictions, indexed like `stats`."""
        t0 = _time.perf_counter()
        if self.start_frame < 0:
            self.start_frame = frame
        self.frame_times[frame] = time
        if self.archive_mode:
            self._cur_stats = stats
            self._cur_preds = predictions

        table, big_rows = self.build_candidates(
            lines, pixels, line_start, pixel_start, stats)

        has, tdelta, tprob = self._caches(frame, time)
        F = self.n_fish
        # global frame-to-frame delta: position probabilities divide the
        # distance from the estimate by ONE frame time for every fish
        # (Individual.cpp:1753 local_tdelta), not by the per-fish gap
        prev_t = self.frame_times.get(frame - 1)
        global_td = (time - prev_t) if prev_t is not None else 0.0
        speed_td = np.full(F, global_td if global_td > 0 else np.inf)
        est_x, est_y = self._position_estimates(frame, time)
        # the history split measures from recently seen fish only
        pos_ok = has & (self.last_frame[:F]
                        >= frame - self.frame_rate * self.t_max)
        fish_pos = np.stack([est_x[:F][pos_ok], est_y[:F][pos_ok]], 1) \
            if pos_ok.any() else np.zeros((0, 2))

        if big_rows and frame == self.start_frame:
            table = self._split_big_start(table, np.asarray(big_rows))
        if frame != self.start_frame and self.settings[
                "track_do_history_split"]:
            table = self._apply_history_split(table, fish_pos)

        B = table.n
        assigned_fish: set[int] = set()
        assigned_blob = np.zeros(B, bool)
        result = MatchResult(mode=self.mode)
        posture_rows: list[tuple[int, int]] = []

        if F and B:
            # active set only: fish seen less than t_max ago
            usable = has & (tprob > 0) & (tdelta < self.t_max)
            uf = np.flatnonzero(usable)
            if len(uf):
                match_fn = self._match_native if self.use_native \
                    else self._match_py
                fob, pob = match_fn(uf, speed_td, tprob, table, B, est_x,
                                    est_y)
                bs = np.flatnonzero(fob >= 0)
                if len(bs):
                    fids = fob[bs]
                    assigned_blob[bs] = True
                    assigned_fish.update(fids.tolist())
                    posture_rows.extend(zip(fids.tolist(), bs.tolist()))
                    self._assign(fids, frame, time, table.cx[bs],
                                 table.cy[bs])
                    self.history[frame] = {
                        "fish": fids.astype(np.int64),
                        "x": table.cx[bs].copy(),
                        "y": table.cy[bs].copy(),
                        "prob": pob[bs].copy(),
                    }

        # second pass: free blobs -> inactive or new fish. Only fish whose
        # gap is >= t_max (or never seen) may reactivate; the probability
        # divides by the global one-frame delta.
        free = np.flatnonzero(~assigned_blob)
        if len(free):
            inactive_ok = (~has) | (tdelta >= self.t_max)
            self._second_pass(table, free, frame, time, speed_td,
                              assigned_fish, assigned_blob, inactive_ok,
                              posture_rows)
        if self.archive_mode and posture_rows:
            self._archive_frame(frame, table, posture_rows)
        if self.do_posture and posture_rows:
            self._run_posture_batch(frame, table, posture_rows)

        self.end_frame = frame
        self.statistics[frame] = FrameStatistics(
            number_fish=len(assigned_fish),
            adding_seconds=_time.perf_counter() - t0,
            match_improvements=result.improvements_made)
        return result

    def _reactivate_py(self, cand_f: np.ndarray, free: np.ndarray,
                       table: _CandTable, tdelta: np.ndarray):
        """Greedy over free blobs in index order against inactive fish:
        p = p_min + (1/sqdist/tdelta)(1 - p_min)."""
        has = self.n_basic[cand_f] > 0
        lx = self.last_x[cand_f]
        ly = self.last_y[cand_f]
        td = tdelta[cand_f]
        bx = table.cx[free]
        by = table.cy[free]
        sq = (bx[None, :] - lx[:, None]) ** 2 \
            + (by[None, :] - ly[:, None]) ** 2
        with np.errstate(divide="ignore"):
            p = np.where(sq > 0, 1.0 / sq / td[:, None],
                         1.0 / td[:, None])
        p = np.where(td[:, None] <= 0, 1.0, p)
        p = self.p_min + p * (1.0 - self.p_min)
        p = np.where(has[:, None], p, self.p_min)
        taken = np.zeros(len(cand_f), bool)
        newly: list[tuple[int, int]] = []
        for j in range(len(free)):
            col = np.where(taken, -1.0, p[:, j])
            k = int(np.argmax(col))
            if col[k] <= 0:
                continue
            taken[k] = True
            newly.append((int(cand_f[k]), int(free[j])))
        return newly

    def _reactivate_native(self, cand_f: np.ndarray, free: np.ndarray,
                           table: _CandTable, tdelta: np.ndarray):
        """``trex_track_reactivate``: the same greedy as _reactivate_py."""
        cand32 = np.ascontiguousarray(cand_f, np.int32)
        hh = np.ascontiguousarray(self.n_basic[cand_f] > 0, np.uint8)
        free32 = np.ascontiguousarray(free, np.int32)
        cx = np.ascontiguousarray(table.cx)
        cy = np.ascontiguousarray(table.cy)
        fob = np.full(table.n, -1, np.int32)
        _lib().trex_track_reactivate(
            cand32.ctypes.data_as(_i32p), len(cand32),
            hh.ctypes.data_as(ctypes.c_char_p),
            self.last_x.ctypes.data_as(_f64p),
            self.last_y.ctypes.data_as(_f64p),
            tdelta.ctypes.data_as(_f64p), free32.ctypes.data_as(_i32p),
            len(free32), cx.ctypes.data_as(_f64p),
            cy.ctypes.data_as(_f64p), self.p_min,
            fob.ctypes.data_as(_i32p))
        return [(int(fob[b]), int(b)) for b in free.tolist() if fob[b] >= 0]

    def _second_pass(self, table: _CandTable, free: np.ndarray,
                     frame: int, time: float, tdelta: np.ndarray,
                     assigned_fish: set, assigned_blob: np.ndarray,
                     inactive_ok: np.ndarray, posture_rows: list):
        """Reactivation (Tracker.cpp:1846-1975), then new individuals.
        Only inactive fish (gap >= t_max, or never assigned) take part.
        Each assignment joins `posture_rows` as (fish, row)."""
        mask = inactive_ok[:self.n_fish].copy()
        if assigned_fish:
            mask[np.fromiter(assigned_fish, np.int64,
                             len(assigned_fish))] = False
        cand_f = np.flatnonzero(mask)
        if len(cand_f) and len(free):
            react = self._reactivate_native if self.use_native \
                else self._reactivate_py
            newly = react(cand_f, free, table, tdelta)
            for _, bi in newly:
                assigned_blob[bi] = True
            if newly:
                fids = np.asarray([f for f, _ in newly])
                rows = np.asarray([r for _, r in newly])
                posture_rows.extend(newly)
                self._assign(fids, frame, time, table.cx[rows],
                             table.cy[rows])
                assigned_fish.update(fids.tolist())
                self._append_history(frame, fids, table.cx[rows],
                                     table.cy[rows])
        # brand-new individuals while under the cap; they do not count
        # into number_fish (Tracker.add second-pass creation semantics)
        for bi in [int(b) for b in free if not assigned_blob[b]]:
            if self.n_fish >= self.F:
                break
            fid = self.n_fish
            self.n_fish += 1
            posture_rows.append((fid, bi))
            self._assign(np.asarray([fid]), frame, time, table.cx[[bi]],
                         table.cy[[bi]])
            assigned_blob[bi] = True
            self._append_history(frame, np.asarray([fid]), table.cx[[bi]],
                                 table.cy[[bi]])

    def _append_history(self, frame, fids, xs, ys):
        """Second-pass assignments join the frame's history with
        probability 0."""
        h = self.history.setdefault(
            frame, {"fish": np.zeros(0, np.int64), "x": np.zeros(0),
                    "y": np.zeros(0), "prob": np.zeros(0)})
        h["fish"] = np.concatenate([h["fish"], fids])
        h["x"] = np.concatenate([h["x"], xs])
        h["y"] = np.concatenate([h["y"], ys])
        h["prob"] = np.concatenate([h["prob"], np.zeros(len(fids))])

    def _run_posture_batch(self, frame: int, table: _CandTable,
                           pairs: list):
        """Posture of this frame's (fish, row) assignments in one native
        call, each fish's previous midline direction orienting its
        midline (:func:`posture_of_pairs`); archive mode records the full
        geometry (PostureRecs, ``track/archive.py``)."""
        h, recs = posture_of_pairs(self.settings, self.background, table,
                                   pairs, self._posture_dir,
                                   self._row_prediction, self.archive_mode)
        if h is None:
            return
        self.posture_history[frame] = h
        if self.archive_mode:
            self.posture_archive[frame] = recs
            self._individuals_cache = None

    def _row_prediction(self, table: _CandTable, r: int):
        """The pose or outline prediction of a table row (the reference's
        posture source precedence), or None."""
        o = table.objs[r]
        pred = getattr(o, "prediction", None) if o is not None else None
        if pred is None and table.srow is not None \
                and self._cur_preds is not None:
            sr = int(table.srow[r])
            if 0 <= sr < len(self._cur_preds):
                pred = self._cur_preds[sr]
        if not isinstance(pred, dict):
            return None
        kp = pred.get("keypoints")
        orig = pred.get("original_outline")
        if kp is not None and len(np.asarray(kp).reshape(-1, 2)):
            return pred
        if orig is not None and len(orig):
            return pred
        return None

    # -- per-individual archives (archive mode) ---------------------------
    def _materialize_row(self, table: _CandTable, r: int):
        """The archived TrackBlob of table row r, with its own copies of
        lines, pixels and stats: what Individual.add and the export and
        crop consumers read (centre, orientation, num_pixels, blob_id,
        split flags, pixels), as the object tracker's BasicStuff keeps
        it."""
        o = table.objs[r]
        if o is not None:
            if o.lines is None:
                return None  # _StatPiece: not produced in archive mode
            st = getattr(o, "stats", None)
            pid = getattr(o, "parent_id", -1)
            px = getattr(o, "pixels", None)
            tb = TrackBlob(np.array(o.lines, np.int32),
                           None if px is None else np.array(px),
                           split=bool(getattr(o, "split", False)),
                           parent_id=-1 if pid is None else int(pid),
                           stats=None if st is None else np.array(st))
            tb.prediction = getattr(o, "prediction", None)
            return tb
        lines = np.array(table.lines[table.line_lo[r]:table.line_hi[r]],
                         np.int32)
        pixels = None
        if table.pixel_lo[r] >= 0:
            pixels = np.array(
                table.pixels[table.pixel_lo[r]:table.pixel_hi[r]])
        st = None
        sr = int(table.srow[r]) if table.srow is not None else -1
        if sr >= 0 and self._cur_stats is not None \
                and sr < len(self._cur_stats):
            st = np.array(self._cur_stats[sr])
        # the object tracker's prefilter wraps every passing blob as its
        # track-threshold child (split, parent_id the parent's id; an
        # all-passing child shares its parent's lines, so parent_id is
        # its own blob id); table rows are those all-passing or huge
        # parents
        rec = table.recount[r]
        close = (not self.fish_size) \
            or bool(_in_close(np.asarray([rec]), self.fish_size)[0])
        huge = bool(self.fish_size) \
            and rec > self.fish_size.max_range[1] * 100
        split = bool(self.track_thr > 0 and table.pixel_lo[r] >= 0
                     and st is not None and close
                     and (st[1] > 0 or huge))
        tb = TrackBlob(lines, pixels, split=split, stats=st)
        if split:
            tb.parent_id = tb.blob_id
        if sr >= 0 and self._cur_preds is not None \
                and sr < len(self._cur_preds):
            tb.prediction = self._cur_preds[sr]
        return tb

    def _archive_frame(self, frame: int, table: _CandTable, pairs: list):
        fids = []
        blobs = []
        for fid, r in pairs:
            b = self._materialize_row(table, r)
            if b is None:
                continue
            fids.append(int(fid))
            blobs.append(b)
        self.frame_archive[frame] = (fids, blobs)
        self._individuals_cache = None

    @property
    def individuals(self):
        """Per-identity archive, built at first use from the frame and
        posture records (track/archive.build_individuals). Raises
        AttributeError when archive mode is off, so that callers testing
        with hasattr keep to the positional history."""
        if not self.archive_mode:
            raise AttributeError(
                "individuals needs keep_individuals=True (archive mode); "
                "this engine kept positional history only")
        if self._individuals_cache is None:
            self._individuals_cache = build_individuals(self)
        return self._individuals_cache

    def _split_big_start(self, table: _CandTable,
                         big_rows: np.ndarray) -> _CandTable:
        """Start-frame split of oversized blobs (tracker.py add())."""
        s = self.settings
        drop = np.zeros(table.n, bool)
        insert: dict[int, list] = {}
        for bi in big_rows.tolist():
            b = table.blob(bi)
            want = 2
            if self.fish_size:
                mid = sum(self.fish_size.max_range) / 2 or 1.0
                want = max(2, int(round(table.recount[bi] / mid))
                           if mid else 2)
            parts = []
            while want >= 2 and not parts:
                parts = split_blob(b, want, self.background, s)
                want -= 1
            kept = []
            for p in parts:
                if self.fish_size.in_range_of_one(p.num_pixels
                                                  * self.cm_sqr):
                    p.recount(self.track_thr, self.background, s)
                    kept.append(p)
            drop[bi] = True
            if kept:
                insert[bi] = kept
        return _rebuild_with_splits(table, drop, insert, self.fish_size,
                                    self.cm_sqr, start_frame=True)

    # -- compatibility surface -------------------------------------------
    def add_frame_blobs(self, frame: int, time: float,
                        blobs: list) -> MatchResult:
        """Track a frame given TrackBlob-like objects: concatenates
        their line/pixel arrays and computes labeler-identical stats
        natively when absent."""
        if self.settings["tags_dont_track"]:
            # physical-tag objects never track (Tracker.cpp:776)
            blobs = [b for b in blobs if not (getattr(b, "flags", 0) & 0x2)]
        return self.add_frame(frame, time,
                              *raw_from_blobs(blobs, self.background,
                                              self.track_thr,
                                              self.absolute),
                              predictions=self._blob_predictions(blobs))

    def _blob_predictions(self, blobs: list):
        """The blobs' predictions in archive mode (None when none has
        one)."""
        if not self.archive_mode:
            return None
        preds = [getattr(b, "prediction", None) for b in blobs]
        return preds if any(p is not None for p in preds) else None


def raw_from_blobs(blobs: list, background: np.ndarray, track_thr: int,
                   absolute: bool) -> tuple:
    """TrackBlob-likes -> the labeler's flat arrays (lines, pixels,
    line_start, pixel_start, stats); stats computed natively when a
    blob lacks them. Rows without pixel data get pixel_start -1."""
    n = len(blobs)
    if n == 0:
        return (np.zeros((0, 3), np.int32), np.zeros(0, np.uint8),
                np.zeros(1, np.int64), np.zeros(1, np.int64),
                np.zeros((0, 8)))
    lines = np.concatenate([np.asarray(b.lines, np.int32) for b in blobs])
    have_px = all(b.pixels is not None for b in blobs)
    pixels = np.concatenate([b.pixels for b in blobs]) if have_px \
        else np.zeros(0, np.uint8)
    line_start = np.zeros(n + 1, np.int64)
    np.cumsum([len(b.lines) for b in blobs], out=line_start[1:])
    if have_px:
        pixel_start = np.zeros(n + 1, np.int64)
        np.cumsum([len(b.pixels) for b in blobs], out=pixel_start[1:])
    else:
        pixel_start = np.full(n + 1, -1, np.int64)
    if all(b.stats is not None for b in blobs):
        stats = np.stack([b.stats for b in blobs])
    else:
        if not have_px:
            raise EngineUnsupported("blobs without pixels or stats")
        stats = blob_stats(lines, line_start, pixels, pixel_start,
                           background, track_thr, absolute)
    return lines, pixels, line_start, pixel_start, stats


def posture_of_pairs(settings, background, table: _CandTable, pairs: list,
                     pdir: np.ndarray, row_prediction,
                     want_recs: bool = False):
    """Posture of a frame's (fish, row) pairs through the native batch
    chain (``track/archive.compute_posture_rows``): the movement direction
    of each fish is its previous midline direction `pdir` negated
    (run_postures' movement_direction), and `pdir` (F, 2) is updated in
    place. Rows without pixel data get no posture. Returns the frame's
    posture history entry {fish, ok, midline_length, angle} and, with
    `want_recs`, its (fish, PostureRec) records (else None); (None, None)
    when no row has pixels."""
    line_arrays = []
    pixel_arrays = []
    fids = []
    preds = []
    for fid, r in pairs:
        if table.objs[r] is not None:
            b = table.objs[r]
            if b.lines is None or getattr(b, "pixels", None) is None:
                continue
            line_arrays.append(np.asarray(b.lines, np.int32))
            pixel_arrays.append(b.pixels)
        else:
            if table.pixel_lo[r] < 0:
                continue
            line_arrays.append(table.lines[table.line_lo[r]:table.line_hi[r]])
            pixel_arrays.append(
                table.pixels[table.pixel_lo[r]:table.pixel_hi[r]])
        fids.append(fid)
        preds.append(row_prediction(table, r))
    if not fids:
        return None, None
    fid_arr = np.asarray(fids, np.int64)
    ok, lens, angles, out_dirs, recs, dir_reset = compute_posture_rows(
        settings, background, line_arrays, pixel_arrays, preds,
        -pdir[fid_arr], want_recs=want_recs)
    # outline-only rows reset the stored direction (run_postures reads
    # prev.midline, which is None for those)
    pdir[fid_arr[dir_reset]] = 0.0
    good = np.flatnonzero(ok)
    if len(good):
        pdir[fid_arr[good]] = out_dirs[good]
    h = {"fish": fid_arr, "ok": np.asarray(ok, bool),
         "midline_length": lens, "angle": angles}
    if not want_recs:
        return h, None
    return h, [(int(fid_arr[i]), recs[i]) for i in range(len(fids))
               if recs[i] is not None]


def _in_close(recount: np.ndarray, fish_size: SizeFilters) -> np.ndarray:
    out = np.zeros(recount.shape, bool)
    for lo, _ in fish_size.ranges:
        out |= recount >= lo * 0.5
    return out


def _filter_table(t: _CandTable, keep: np.ndarray) -> _CandTable:
    idx = np.flatnonzero(keep)
    return _CandTable(
        n=len(idx), cnt=t.cnt[idx], recount=t.recount[idx],
        cx=t.cx[idx], cy=t.cy[idx], bx0=t.bx0[idx], by0=t.by0[idx],
        bx1=t.bx1[idx], by1=t.by1[idx],
        line_lo=t.line_lo[idx], line_hi=t.line_hi[idx],
        objs=[t.objs[i] for i in idx.tolist()],
        lines=t.lines, pixel_lo=t.pixel_lo[idx],
        pixel_hi=t.pixel_hi[idx], pixels=t.pixels,
        srow=t.srow[idx] if t.srow is not None else None)


def _rebuild_with_splits(t: _CandTable, drop: np.ndarray,
                         insert: dict[int, list], fish_size: SizeFilters,
                         cm_sqr: float,
                         start_frame: bool = False) -> _CandTable:
    """Replace dropped rows by their split pieces, in order, at the
    parent's place, and apply the final size filter (HistorySplit.cpp:
    364-373). At the start frame the pieces are pre-filtered and no
    final filter applies."""
    keep = ~drop
    if not start_frame and fish_size:
        keep &= _in_range_rows(t.recount, fish_size.ranges)
    base = _filter_table(t, keep)
    base_pos = np.flatnonzero(keep).astype(np.float64)
    prow: list = []
    pobj: list = []
    for bi in sorted(insert):
        for k, p in enumerate(insert[bi]):
            if start_frame or not fish_size \
                    or fish_size.in_range_of_one(p.recount(-1)):
                # a fractional position keeps the pieces in order
                prow.append(bi + (k + 1) / (len(insert[bi]) + 2))
                pobj.append(p)
    if not pobj:
        return base
    m = len(pobj)
    centers = np.asarray([p.center for p in pobj])
    bounds = np.asarray([p.bounds for p in pobj], np.float64)
    none = np.full(m, -1, np.int64)
    pieces = _CandTable(
        n=m, cnt=np.fromiter((p.num_pixels for p in pobj), np.float64, m),
        recount=np.fromiter((p.recount(-1) for p in pobj), np.float64, m),
        cx=centers[:, 0], cy=centers[:, 1],
        bx0=bounds[:, 0], by0=bounds[:, 1],
        bx1=bounds[:, 0] + bounds[:, 2] - 1,
        by1=bounds[:, 1] + bounds[:, 3] - 1,
        line_lo=none, line_hi=none, objs=pobj, lines=t.lines,
        pixel_lo=none, pixel_hi=none, pixels=t.pixels, srow=none)
    order = np.argsort(np.concatenate([base_pos, np.asarray(prow)]),
                       kind="stable")
    return _concat_tables(base, pieces, order)


def _concat_tables(a: _CandTable, b: _CandTable,
                   order: np.ndarray) -> _CandTable:
    objs = a.objs + b.objs

    def cat(name):
        return np.concatenate([getattr(a, name), getattr(b, name)])[order]

    def srow(t):
        return t.srow if t.srow is not None else np.full(t.n, -1, np.int64)
    return _CandTable(
        n=len(order), cnt=cat("cnt"), recount=cat("recount"),
        cx=cat("cx"), cy=cat("cy"), bx0=cat("bx0"), by0=cat("by0"),
        bx1=cat("bx1"), by1=cat("by1"), line_lo=cat("line_lo"),
        line_hi=cat("line_hi"), objs=[objs[i] for i in order.tolist()],
        lines=a.lines, pixel_lo=cat("pixel_lo"), pixel_hi=cat("pixel_hi"),
        pixels=a.pixels,
        srow=np.concatenate([srow(a), srow(b)])[order])


class _StatPiece:
    """A split piece backed by the native executor's stats only (no
    pixel data); at the chosen split threshold every pixel passes the
    track threshold, so recount == num_pixels * cm^2."""

    __slots__ = ("num_pixels", "_rec", "center", "bounds", "lines")

    def __init__(self, row: np.ndarray, cm_sqr: float):
        n, x0, y0, x1, y1, sx, sy = row
        self.num_pixels = int(n)
        self._rec = float(n) * cm_sqr
        self.center = (sx / n, sy / n)
        self.bounds = (int(x0), int(y0), int(x1 - x0 + 1),
                       int(y1 - y0 + 1))
        self.lines = None

    def recount(self, *args, **kwargs) -> float:
        return self._rec


def _resolve_expectation(edges: dict[int, list]) -> dict[int, int]:
    """Conflict resolution over proximity cliques (HistorySplit.cpp:
    170-320): `edges` maps a fish to its (distance, blob) list sorted by
    distance; returns {blob: expected pieces}."""
    parent: dict = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    for fi, es in edges.items():
        for _, bi in es:
            union(("f", fi), ("b", bi))
    cliques: dict = {}
    for fi in edges:
        cliques.setdefault(find(("f", fi)), ([], set()))[0].append(fi)
    for fi, es in edges.items():
        root = find(("f", fi))
        for _, bi in es:
            cliques[root][1].add(bi)

    expect: dict[int, int] = {}
    for fish_list, blob_set in cliques.values():
        if len(fish_list) <= len(blob_set):
            continue
        combos = {fi: list(edges[fi]) for fi in fish_list}
        assign_fish = {fi: combos[fi][0] for fi in fish_list}
        assign_blob: dict[int, tuple] = {}
        queue = list(fish_list)
        while queue:
            fi = queue.pop(0)
            combo = combos[fi]
            if not combo:
                continue
            d, b = combo[0]
            if b not in assign_blob:
                assign_blob[b] = (fi, d)
                continue
            owner, od = assign_blob[b]
            if owner != fi:
                if od <= d:
                    combo.pop(0)
                    queue.append(fi)
                else:
                    assign_blob[b] = (fi, d)
                    queue.append(owner)
        for fi in fish_list:
            if combos[fi]:
                continue
            d, b = assign_fish[fi]
            if b in assign_blob:
                expect[b] = expect.get(b, 0) + 1
                del assign_blob[b]
            expect[b] = expect.get(b, 0) + 1
    return expect


def _bulk_paired(fish_ids: np.ndarray, blob_ids: np.ndarray,
                 probs: np.ndarray) -> PairedProbabilities:
    """PairedProbabilities from parallel edge arrays, blob slots in
    first-occurrence order. The edges may come fish-major (np.nonzero)
    or clique-major (the native pending edges): a stable sort keeps each
    fish's edge order either way."""
    pp = PairedProbabilities()
    uf, f_inv = np.unique(fish_ids, return_inverse=True)
    ub, b_first = np.unique(blob_ids, return_index=True)
    order = np.argsort(b_first, kind="stable")
    ub_ordered = ub[order]
    slot_of = np.empty(len(ub), np.int64)
    slot_of[order] = np.arange(len(ub))
    b_slot = slot_of[np.searchsorted(ub, blob_ids)]
    pp._fish = [int(f) for f in uf]
    pp._fish_index = {int(f): i for i, f in enumerate(uf)}
    pp._blobs = [int(b) for b in ub_ordered]
    pp._blob_index = {int(b): i for i, b in enumerate(ub_ordered)}
    # bucket edges per fish; a stable sort keeps each fish's edge order
    order = np.argsort(f_inv, kind="stable")
    f_sorted = f_inv[order]
    bs = b_slot[order].tolist()
    ps = probs[order].tolist()
    bounds = np.searchsorted(f_sorted, np.arange(len(uf) + 1))
    for fi in range(len(uf)):
        lo, hi = bounds[fi], bounds[fi + 1]
        pp.edges[fi] = list(zip(bs[lo:hi], ps[lo:hi]))
    return pp
