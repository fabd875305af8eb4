"""DeviceTracker: the product tracking engine on the card.

Counterpart of ``trex_tpu/track/device_engine.py::DeviceTracker``. The
per-frame tracking recurrence runs as one scan per chunk on the card
(``ops/device_tracker.py``), and the engine keeps FastTracker
compatibility: frames the scan flags ``needs_host`` are replayed one
frame at a time through a host FastTracker whose per-fish state is
spliced in from the device carry, and the scan resumes from the
corrected carry at the next frame. On the fused raw-frames path history
splits run on the card (``ops/device_split.py``); the blob-list path
ships no pixels, so its contested frames are replayed. With
``calculate_posture`` the fused path takes its postures from the card's
posture pass, and the blob-list path runs the host's native posture
chain over each committed span, walking the carry's posture-direction
section forward. With ``track_speed_decay < 1`` the carry holds each
fish's motion window and accumulated decay walk; a replay splices the
window into the helper and rebuilds the walk in float64
(``_rebuild_dacc``). Archive mode (``keep_individuals``, blob-list path
only) archives the committed frames from the host-built candidate tables
through the scan's fish_row, the replayed frames inside the helper.

Two ingestion paths:

- ``add_frame_blobs`` / ``finalize``: blob lists (the pv re-track loop).
  The host builds the engine's candidate table per frame, ships compact
  blob tables to the card (``scan_packed``) and scans the chunk.
- ``track_frames``: raw frame batches. Detection runs fused on the card
  (``fused_scan_packed``) and only flagged frames are labelled on the
  host.

Per chunk one packed array goes up and one comes down, each way. The
splice rebuilds the FastTracker's tracklet bookkeeping from the scan's
seen-ring: ``recent_number_samples`` reads only tracklet spans clipped
to the last ``frame_rate`` frames, which the ring covers exactly.

When assists pass a quarter of at least 64 tracked frames, the engine
demotes: the spliced host FastTracker tracks every remaining frame and
the card is not launched again.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..config import SettingsView
from ..device import resolve_device
from ..ops.device_posture import spec_from_settings as posture_spec
from ..ops.device_tracker import (DECAY_WIN, _detect_kwargs,
                                  _track_vec_size,
                                  carry_from_vec_np, carry_to_vec,
                                  default_split_spec, fused_scan_packed,
                                  make_aux, n_fish_index,
                                  params_from_settings, scan_packed,
                                  unpack_result)
from ..ops.labeling import label_blobs_raw
from .archive import build_individuals
from .cache_batch import window_estimate_scalar
from .engine import (EngineUnsupported, FastTracker, posture_of_pairs,
                     raw_from_blobs)
from .tracker import FrameStatistics


def check_device_supported(settings) -> None:
    """The device engine's own limits beyond FastTracker's."""
    s = SettingsView(settings)
    if s["match_mode"] not in ("approximate", "automatic", "hungarian",
                               "tree"):
        raise EngineUnsupported(
            "the device engine takes match_mode approximate, automatic, "
            "hungarian or tree (benchmark needs the host engines)")
    if s["calculate_posture"] and int(s["posture_closing_steps"]):
        raise EngineUnsupported(
            "posture_closing_steps needs the per-blob host chain (ported "
            "with the posture-closing slice)")


def _rebuild_dacc(win: np.ndarray, got: np.ndarray, frame: int,
                  prev_dacc: np.ndarray, frame_times: dict,
                  settings) -> np.ndarray:
    """The carry's accumulated decay walk after a host replay: assigned
    fish reset; an unassigned fish takes the exact float64 walk through
    `frame` (the walk to query frame + 1 less its first term, the walk
    to query prev + 1), which restarts its error column at packing scale.
    `win` is the card's (F, W, 5) window [frame, x, y, time, global
    step]; the scalar walk reads its [:, :4] columns."""
    dacc = np.asarray(prev_dacc).copy()
    dacc[got] = 0.0
    for fi in np.flatnonzero(~got):
        row = win[fi]
        pf = row[row[:, 0] > -1e8]
        if not len(pf):
            continue
        prev_f = int(pf[-1, 0])
        if prev_f >= frame:  # no gap to walk
            continue
        w4 = row[:, :4]
        fx, fy = window_estimate_scalar(
            w4, -(10 ** 9), frame + 1, 0.0, frame_times, settings)
        tx, ty = window_estimate_scalar(
            w4, -(10 ** 9), prev_f + 1, 0.0, frame_times, settings)
        dacc[fi, 0] = fx - tx
        dacc[fi, 1] = fy - ty
        dacc[fi, 2] = 4.0 * 1.1920929e-07 * (
            abs(dacc[fi, 0]) + abs(dacc[fi, 1]) + 1.0)
    return dacc


def _probs_for(h, fish) -> np.ndarray:
    """Per-fid assignment probabilities from a helper history record
    (-1 = unknown, the host Tracker's no-probability sentinel)."""
    if h is None:
        return np.full(len(fish), -1.0)
    lut = {int(fi): float(p) for fi, p in zip(h["fish"], h["prob"])}
    return np.array([lut.get(int(fi), -1.0) for fi in fish])


class DeviceTracker:
    """FastTracker-compatible surface backed by the scan on the card.

    ``device=None`` runs on the CUDA card (and raises without one);
    ``device="cpu"`` runs the scan's plain PyTorch path, for the tests.
    `split_caps` overrides the capacities of the history split on the
    card (``default_split_spec``). With `keep_individuals` (archive mode,
    blob path only) the committed frames are archived from the host-built
    candidate tables through the scan's fish_row, and replayed frames
    inside the helper engine; ``individuals`` builds the per-identity
    archive from them.
    ``scan_seconds`` sums the host wall time of the scan calls, each
    ending in the copy of its packed result to the host, and
    ``frames_scanned`` the frames they scanned (each assist relaunches
    the scan over the rest of its chunk)."""

    CHUNK = 256

    def __init__(self, settings, background: np.ndarray,
                 chunk: int = None, caps: dict = None,
                 split_caps: dict = None, keep_individuals: bool = False,
                 device=None):
        check_device_supported(settings)
        self.settings = SettingsView(settings)
        self.device = resolve_device(device)
        self.background = np.asarray(background)
        self.caps = caps
        self.archive_mode = bool(keep_individuals)
        self.frame_archive: dict[int, tuple] = {}
        self.posture_archive: dict[int, list] = {}
        self._individuals_cache = None
        # host helper: candidate tables and the replay; raises
        # EngineUnsupported for the configurations the port lacks
        self._helper = FastTracker(self.settings, self.background,
                                   keep_individuals=keep_individuals)
        self.P = params_from_settings(self.settings)
        # the history split on the card, for the fused raw-frames path
        self.split_spec = default_split_spec(self.settings, self.P,
                                             split_caps)
        # posture on the card, for the fused raw-frames path (the blob
        # path runs the host's native chain per committed span)
        self.posture_spec = posture_spec(self.settings, crop_h=96,
                                         crop_w=96) \
            if self.P.do_posture else None
        self.posture_history: dict[int, dict] = {}
        self.F = self.P.max_fish
        self.chunk = chunk or self.CHUNK

        self.start_frame = -1
        self.end_frame = -1
        self.n_fish = 0
        self.history: dict[int, dict] = {}
        self.statistics: dict[int, FrameStatistics] = {}
        self.frame_times: dict[int, float] = {}
        self.assist_frames: list[int] = []
        self.scan_seconds = 0.0
        self.frames_scanned = 0

        # every assist costs a host replay plus a fresh scan launch for
        # the rest of the chunk; past a quarter of at least 64 frames
        # the plain host engine is faster
        self.demote_threshold = 0.25
        self.demote_min_frames = 64
        self.demoted = False
        self.demoted_at = None  # the first frame the host tracked
        self._frames_done = 0

        # the carry lives on the host as one packed float32 vector
        # (carry_to_vec layout)
        self._carry_vec = None
        self._buf: list[tuple[int, float, list]] = []

    def _ensure_carry(self, frame: int, time: float):
        if self._carry_vec is None:
            self.start_frame = frame
            F = self.F
            c = dict(last_x=np.zeros(F), last_y=np.zeros(F),
                     last_time=np.zeros(F),
                     last_frame=np.full(F, -(10 ** 9), np.float64),
                     n_basic=np.zeros(F),
                     seen=np.zeros((F, self.P.frame_rate)),
                     n_fish=0, start_frame=frame, prev_time=time)
            if self.P.do_decay:
                win = np.zeros((F, DECAY_WIN, 5))
                win[:, :, 0] = -1e9
                c["win"] = win
            if self.P.do_posture:
                c["posture_dir"] = np.zeros((F, 2))
            self._carry_vec = carry_to_vec(c)

    def _scan(self, launch, span: int):
        """Run one scan launch over `span` frames; returns its packed
        result on the host."""
        t0 = _time.perf_counter()
        vec = launch().cpu().numpy()
        self.scan_seconds += _time.perf_counter() - t0
        self.frames_scanned += span
        return vec

    # -- blob-list ingestion ---------------------------------------------

    def add_frame_blobs(self, frame: int, time: float, blobs: list):
        self._buf.append((frame, time, blobs))
        self.frame_times[frame] = time
        if len(self._buf) >= self.chunk:
            self._flush()

    def finalize(self):
        if self._buf:
            self._flush()
        return self

    @staticmethod
    def _row_lines(t, r):
        return np.asarray(t.objs[r].lines) if t.objs[r] is not None \
            else t.lines[t.line_lo[r]:t.line_hi[r]]

    def _det_packed(self, tables: list):
        """Per-frame candidate tables -> the packed (T, 6B [+ 4R]) det
        array of ``scan_packed``: [cx, cy, bcx, bcy, recount, valid], B
        the largest table, and with history splits on the track-mask run
        tables [y, x0, x1, slot] (slot B pads), R the most runs of a
        frame."""
        B = max(1, max(t.n for t in tables))
        use_runs = self.P.do_history_split and self.P.split_radius > 0
        R = 0
        if use_runs:
            R = max(1, max(sum(len(self._row_lines(t, r))
                               for r in range(t.n)) for t in tables))
        packed = np.zeros((len(tables), 6 * B + 4 * R), np.float32)
        if use_runs:
            packed[:, 6 * B:6 * B + R] = -1          # runs_y padding
            packed[:, 6 * B + 3 * R:] = B            # runs_slot padding
        sq = self.P.cm_per_pixel * self.P.cm_per_pixel
        for i, t in enumerate(tables):
            n = t.n
            packed[i, 0 * B:0 * B + n] = t.cx
            packed[i, 1 * B:1 * B + n] = t.cy
            packed[i, 2 * B:2 * B + n] = (t.bx0 + t.bx1 + 1) * 0.5
            packed[i, 3 * B:3 * B + n] = (t.by0 + t.by1 + 1) * 0.5
            packed[i, 4 * B:4 * B + n] = t.recount / sq
            packed[i, 5 * B:5 * B + n] = 1.0
            if use_runs and n:
                L = np.concatenate([self._row_lines(t, r)
                                    for r in range(n)])
                m = len(L)
                base = 6 * B
                for c in range(3):
                    packed[i, base + c * R:base + c * R + m] = L[:, c]
                packed[i, base + 3 * R:base + 3 * R + m] = np.repeat(
                    np.arange(n), [len(self._row_lines(t, r))
                                   for r in range(n)])
        return packed, B, R

    def _flush(self):
        buf, self._buf = self._buf, []
        frames = [f for f, _, _ in buf]
        times = [t for _, t, _ in buf]
        self._ensure_carry(frames[0], times[0])
        eng = self._helper
        raws = [raw_from_blobs(blobs, self.background, eng.track_thr,
                               eng.absolute) for _, _, blobs in buf]
        tables = [eng.build_candidates(*raw)[0] for raw in raws]
        # archive mode: the blobs' predictions, per source row
        preds = [eng._blob_predictions(blobs) for _, _, blobs in buf]

        i = 0
        while i < len(buf):
            if self._maybe_demote(frames[i], times[i]):
                for k in range(i, len(buf)):
                    self._host_step(frames[k], times[k], raws[k], preds[k])
                break
            span = len(buf) - i
            packed, B, R = self._det_packed(tables[i:])
            aux = make_aux(self._carry_vec, times[i:], frames[i:])
            vec = self._scan(lambda: scan_packed(packed, aux, self.P, B, R,
                                                 device=self.device), span)
            stop, hist = self._commit_span(frames[i:], vec, span)
            if self.archive_mode:
                self._archive_span(frames[i:], tables[i:], raws[i:],
                                   preds[i:], hist, stop)
            # no pixels on the card on this path: posture runs on the
            # host over the committed span
            self._host_posture_span(frames[i:], tables[i:], raws[i:],
                                    preds[i:], hist, stop)
            if stop == span:
                break
            j = i + stop
            self._assist(frames[j], times[j], raws[j], preds[j])
            i = j + 1
        self.end_frame = frames[-1]

    # -- fused raw-frame ingestion ---------------------------------------

    def track_frames(self, frames: np.ndarray, start_frame: int = 0):
        """Detection fused with tracking on the card over a raw frame
        batch, a chunk at a time. Per chunk the frames and one aux vector
        go up and one packed result comes down. Archive mode needs the
        host's blob tables and refuses this path."""
        if self.archive_mode:
            raise EngineUnsupported(
                "archive mode (keep_individuals) needs host blob tables — "
                "feed frames through add_frame_blobs, not the fused "
                "raw-frames path")
        s = self.settings
        fr = float(s["frame_rate"] or 25)
        frames = np.asarray(frames)
        T = len(frames)
        idx = np.arange(start_frame, start_frame + T)
        times = idx / fr
        self._ensure_carry(int(idx[0]), float(times[0]))
        for k, t in zip(idx.tolist(), times.tolist()):
            self.frame_times[k] = float(t)
        caps = self.caps
        if caps is None:
            # runs scale with resolution; a frame that still overflows
            # is replayed on the host
            hw = frames.shape[1] * frames.shape[2]
            caps = dict(max_runs=max(4096, hw // 128),
                        max_child_runs=max(4096, hw // 128),
                        max_pixels=max(1 << 16, hw // 8))
        kw = _detect_kwargs(s, caps)
        ddet = dict(threshold=kw["detect_threshold"],
                    absolute=kw["detect_absolute"],
                    track_threshold=kw["track_threshold"],
                    track_absolute=kw["track_absolute"])

        def raw_of(k):
            raw = label_blobs_raw(frames[k], self.background, **ddet)
            return (raw["lines"], raw["pixels"], raw["line_start"],
                    raw["pixel_start"], raw["stats"])

        bg_dev = torch.as_tensor(self.background, device=self.device)
        i = 0
        while i < T:
            if self._maybe_demote(int(idx[i]), float(times[i])):
                for k in range(i, T):
                    self._host_step(int(idx[k]), float(times[k]),
                                    raw_of(k))
                break
            j = min(T, i + self.chunk)
            aux = make_aux(self._carry_vec, times[i:j], idx[i:j])
            vec = self._scan(lambda: fused_scan_packed(
                frames[i:j], bg_dev, aux, self.P,
                split_spec=self.split_spec, posture_spec=self.posture_spec,
                device=self.device, **kw), j - i)
            stop, _ = self._commit_span(idx[i:j], vec, j - i,
                                        posture_from_hist=True)
            if stop == j - i:
                i = j
                continue
            k = i + stop
            self._assist(int(idx[k]), float(times[k]), raw_of(k))
            i = k + 1
        self.end_frame = int(idx[-1])
        return self

    def _commit_span(self, frames, vec, span: int,
                     posture_from_hist: bool = False):
        """Commit a scan's frames up to the first flagged one (needs_host,
        or a detect overflow of the fused path) and resume the carry from
        the row before it. Returns the number committed (``span`` when no
        frame is flagged) and the unpacked history."""
        hist, carry_rows = unpack_result(vec, span, self.P)
        flags = hist["needs_host"] | hist["detect_overflow"]
        stop = int(np.argmax(flags)) if flags.any() else span
        if stop:
            # n_fish as of the commit horizon, not the chunk's end
            hist["n_fish"] = np.int32(
                carry_rows[stop - 1][n_fish_index(self.P)])
            self._carry_vec = carry_rows[stop - 1]
        self._commit_history(frames[:stop], hist, stop, posture_from_hist)
        self._frames_done += stop
        return stop, hist

    # -- archives (archive mode) ------------------------------------------

    def _archive_span(self, frames, tables, raws, preds, hist, stop: int):
        """Archive `stop` committed blob-path frames: each assignment as a
        lean blob of the host-built candidate table
        (FastTracker._materialize_row), its row from the scan's
        fish_row."""
        eng = self._helper
        rows_h = np.asarray(hist["fish_row"])
        for k in range(stop):
            t = tables[k]
            eng._cur_stats = raws[k][4]
            eng._cur_preds = preds[k]
            rows = rows_h[k]
            out_f = []
            out_b = []
            for fid in np.flatnonzero(rows >= 0).tolist():
                r = int(rows[fid])
                if r >= t.n:
                    continue
                b = eng._materialize_row(t, r)
                if b is None:
                    continue
                out_f.append(int(fid))
                out_b.append(b)
            self.frame_archive[int(frames[k])] = (out_f, out_b)
        self._individuals_cache = None

    @property
    def individuals(self):
        """Per-identity archive (see FastTracker.individuals)."""
        if not self.archive_mode:
            raise AttributeError(
                "individuals needs keep_individuals=True (archive mode); "
                "this engine kept positional history only")
        if self._individuals_cache is None:
            self._individuals_cache = build_individuals(self)
        return self._individuals_cache

    # -- host assist (per-frame replay) ----------------------------------

    def _host_posture_span(self, frames, tables, raws, preds, hist,
                           stop: int):
        """Posture of `stop` committed blob-path frames on the host (the
        native chain FastTracker runs), walking the carry's posture-
        direction section forward and writing it back, so that the next
        scan and the replay start from the directions after the span;
        archive mode keeps the posture records."""
        if not self.P.do_posture or not stop:
            return
        eng = self._helper
        F = self.F
        base = _track_vec_size(self.P)
        # carry rows of the unpacked result can be read-only views
        self._carry_vec = np.array(self._carry_vec, np.float32)
        pdir = self._carry_vec[base:base + 2 * F].reshape(F, 2) \
            .astype(np.float64)
        rows_h = np.asarray(hist["fish_row"])
        for k in range(stop):
            t = tables[k]
            eng._cur_stats = raws[k][4]
            eng._cur_preds = preds[k]
            rows = rows_h[k]
            pairs = [(fid, int(rows[fid]))
                     for fid in np.flatnonzero(rows >= 0).tolist()
                     if rows[fid] < t.n]
            h, recs = posture_of_pairs(self.settings, self.background, t,
                                       pairs, pdir, eng._row_prediction,
                                       self.archive_mode)
            if h is None:
                continue
            f = int(frames[k])
            self.posture_history[f] = h
            if self.archive_mode:
                self.posture_archive[f] = recs
                self._individuals_cache = None
        self._carry_vec[base:base + 2 * F] = pdir.astype(np.float32).ravel()

    def _sync_helper_state(self, frame: int, time: float):
        """Inject the device carry into the host FastTracker."""
        eng = self._helper
        c = carry_from_vec_np(self._carry_vec, self.P)
        F = self.F
        eng.n_fish = int(c["n_fish"])
        eng.start_frame = self.start_frame
        eng.last_x[:] = np.asarray(c["last_x"], np.float64)
        eng.last_y[:] = np.asarray(c["last_y"], np.float64)
        eng.last_time[:] = np.asarray(c["last_time"], np.float64)
        eng.last_frame[:] = np.asarray(c["last_frame"], np.int64)
        eng.n_basic[:] = np.asarray(c["n_basic"], np.int64)
        if self.P.do_posture:
            eng._posture_dir[:F] = np.asarray(c["posture_dir"])
        if self.P.do_decay:
            # the motion window (frame, x, y, time) of the helper's decay
            # estimates; its scalar walk reads frame_times, so it gets the
            # whole history
            eng.win[:F] = np.asarray(c["win"])[:, :, :4]
        eng.frame_times = dict(self.frame_times)
        eng.frame_times[frame - 1] = float(c["prev_time"])
        eng.frame_times[frame] = time
        # tracklet bookkeeping from the seen-ring: runs of consecutive
        # seen bits, absolute frames; a span reaching the ring's edge is
        # clipped to -inf (recent_number_samples clips at the window's
        # lower bound anyway)
        seen = np.asarray(c["seen"])
        W = seen.shape[1]
        NEG = -(10 ** 9)
        eng.trk_start[:] = NEG
        eng.prev_trk_end[:] = NEG
        # the native caches of the automatic replay walk the ring
        eng.trk_ring[:] = 0
        eng.trk_ring_n[:] = 0
        eng.closed_tracklets = [[] for _ in range(F)]
        for fid in range(int(c["n_fish"])):
            bits = seen[fid]
            if not bits.any():
                continue
            # bit k == seen at frame (frame - W + k)
            runs = []
            in_run = False
            for k in range(W):
                if bits[k] and not in_run:
                    s0 = frame - W + k
                    in_run = True
                elif not bits[k] and in_run:
                    runs.append([s0, frame - W + k - 1])
                    in_run = False
            if in_run:
                runs.append([s0, frame - 1])
            if runs[0][0] == frame - W:
                runs[0][0] = NEG  # may extend past the ring
            eng.trk_start[fid] = runs[-1][0]
            closed = runs[:-1]
            if closed:
                eng.prev_trk_end[fid] = closed[-1][1]
                eng.closed_tracklets[fid] = closed
                m = min(len(closed), eng.RING)
                eng.trk_ring[fid, :m] = np.asarray(closed[-m:], np.int64)
                eng.trk_ring_n[fid] = m

    def _assist(self, frame: int, time: float, raw: tuple, preds=None):
        """Replay one flagged frame through the host engine and rebuild
        the carry from its state."""
        t0 = _time.perf_counter()
        self._sync_helper_state(frame, time)
        eng = self._helper
        eng.add_frame(frame, time, *raw, predictions=preds)
        self.assist_frames.append(frame)
        self._frames_done += 1
        got = self._harvest_host_frame(frame)
        prev = carry_from_vec_np(self._carry_vec, self.P)
        F = self.F
        c = dict(
            last_x=eng.last_x[:F], last_y=eng.last_y[:F],
            last_time=eng.last_time[:F],
            last_frame=np.clip(eng.last_frame[:F], -(10 ** 9), None),
            n_basic=eng.n_basic[:F],
            seen=np.concatenate([prev["seen"][:, 1:], got[:, None]], 1),
            n_fish=eng.n_fish, start_frame=self.start_frame,
            prev_time=time)
        if self.P.do_decay:
            # assigned fish shift and append this frame's window entry, as
            # the scan's carry update does; the older entries and their
            # global steps ride from the previous carry
            win = prev["win"].copy()
            fids = np.flatnonzero(got)
            if len(fids):
                win[fids, :-1] = win[fids, 1:]
                win[fids, -1, 0] = frame
                win[fids, -1, 1] = eng.last_x[fids]
                win[fids, -1, 2] = eng.last_y[fids]
                win[fids, -1, 3] = time
                win[fids, -1, 4] = time - float(prev["prev_time"])
            c["win"] = win
            c["dacc"] = _rebuild_dacc(win, got, frame, prev["dacc"],
                                      self.frame_times, self.settings)
        if self.P.do_posture:
            c["posture_dir"] = eng._posture_dir[:F]
        self._carry_vec = carry_to_vec(c)
        st = self.statistics[frame]
        self.statistics[frame] = FrameStatistics(
            number_fish=st.number_fish,
            adding_seconds=_time.perf_counter() - t0,
            match_improvements=st.match_improvements)

    def _harvest_host_frame(self, frame: int):
        """Copy the helper engine's results for `frame` into this
        tracker's tables. Returns the per-fish seen mask."""
        eng = self._helper
        got = eng.last_frame[:self.F] == frame
        fish = np.flatnonzero(got)
        self.history[frame] = {
            "fish": fish.astype(np.int64),
            "x": eng.last_x[fish].copy(),
            "y": eng.last_y[fish].copy(),
            "prob": _probs_for(eng.history.get(frame), fish),
        }
        self.statistics[frame] = eng.statistics[frame]
        self.n_fish = max(self.n_fish, eng.n_fish)
        if self.P.do_posture:
            ph = eng.posture_history.get(frame)
            if ph is not None:
                self.posture_history[frame] = ph
        if self.archive_mode:
            fa = eng.frame_archive.get(frame)
            if fa is not None:
                self.frame_archive[frame] = fa
            pa = eng.posture_archive.get(frame)
            if pa is not None:
                self.posture_archive[frame] = pa
            self._individuals_cache = None
        return got

    def _maybe_demote(self, frame: int, time: float) -> bool:
        """Sticky switch to pure host tracking once assists dominate.
        Syncs the helper engine from the device carry on entry; from
        then on the helper is the tracker and the card is not launched
        again."""
        if self.demoted:
            return True
        if (self._frames_done >= self.demote_min_frames
                and len(self.assist_frames)
                > self.demote_threshold * self._frames_done):
            self._sync_helper_state(frame, time)
            self.demoted = True
            self.demoted_at = frame
        return self.demoted

    def _host_step(self, frame: int, time: float, raw: tuple, preds=None):
        """One frame fully on the (already synced) host engine."""
        self._helper.add_frame(frame, time, *raw, predictions=preds)
        self._harvest_host_frame(frame)
        self._frames_done += 1

    # -- result harvesting ------------------------------------------------

    def _commit_history(self, frames, hist, stop: int,
                        posture_from_hist: bool = False):
        """Copy `stop` scanned frames into the history tables, and with
        `posture_from_hist` their postures from the card's posture pass."""
        fx = np.asarray(hist["fish_x"])
        fy = np.asarray(hist["fish_y"])
        seen = np.asarray(hist["fish_seen"])
        n_assigned = np.asarray(hist["n_assigned"])
        fprob = np.asarray(hist["fish_prob"])
        for k in range(stop):
            f = int(frames[k])
            fid = np.flatnonzero(seen[k])
            self.history[f] = {
                "fish": fid.astype(np.int64),
                "x": fx[k, fid].astype(np.float64),
                "y": fy[k, fid].astype(np.float64),
                "prob": fprob[k, fid].astype(np.float64),
            }
            self.statistics[f] = FrameStatistics(
                number_fish=int(n_assigned[k]))
            if posture_from_hist and self.P.do_posture:
                pf = np.flatnonzero(np.asarray(hist["fish_row"][k]) >= 0)
                self.posture_history[f] = {
                    "fish": pf.astype(np.int64),
                    "ok": np.asarray(hist["p_ok"][k])[pf],
                    "midline_length": np.asarray(hist["p_len"][k])[pf],
                    "angle": np.asarray(hist["p_ang"][k])[pf],
                }
        if stop:
            self.n_fish = max(self.n_fish, int(hist["n_fish"]))

    def positions(self) -> dict:
        """Dense history arrays: fish_x/fish_y (T, F), fish_seen."""
        return positions_of(self)


def positions_of(tracker) -> dict:
    """Dense (T, F) position history from any history engine
    (FastTracker and DeviceTracker share the history-dict schema), with
    midline_length, midline_angle and posture_ok when the tracker has a
    posture history."""
    F = tracker.F
    if tracker.start_frame < 0:
        return dict(frames=np.zeros(0, np.int64), fish_x=np.zeros((0, F)),
                    fish_y=np.zeros((0, F)),
                    fish_seen=np.zeros((0, F), bool))
    frames = np.arange(tracker.start_frame, tracker.end_frame + 1)
    T = len(frames)
    fx = np.zeros((T, F))
    fy = np.zeros((T, F))
    seen = np.zeros((T, F), bool)
    for i, f in enumerate(frames):
        h = tracker.history.get(int(f))
        if not h:
            continue
        fid = np.asarray(h["fish"], np.int64)
        ok = fid < F
        fx[i, fid[ok]] = np.asarray(h["x"])[ok]
        fy[i, fid[ok]] = np.asarray(h["y"])[ok]
        seen[i, fid[ok]] = True
    out = dict(frames=frames, fish_x=fx, fish_y=fy, fish_seen=seen)
    ph = getattr(tracker, "posture_history", None)
    if ph:
        plen = np.zeros((T, F))
        pang = np.zeros((T, F))
        pok = np.zeros((T, F), bool)
        for i, f in enumerate(frames):
            h = ph.get(int(f))
            if not h:
                continue
            fid = np.asarray(h["fish"], np.int64)
            keep = fid < F
            pok[i, fid[keep]] = np.asarray(h["ok"])[keep]
            plen[i, fid[keep]] = np.asarray(h["midline_length"])[keep]
            pang[i, fid[keep]] = np.asarray(h["angle"])[keep]
        out.update(midline_length=plen, midline_angle=pang, posture_ok=pok)
    return out


def export_positions(tracker, path) -> None:
    """Position-history npz for the history engines (fast/device)."""
    np.savez_compressed(path, **positions_of(tracker))
