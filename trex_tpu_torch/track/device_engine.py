"""DeviceTracker: the product tracking engine on the card, base
configuration.

Counterpart of ``trex_tpu/track/device_engine.py::DeviceTracker``. The
per-frame tracking recurrence runs as one scan per chunk on the card
(``ops/device_tracker.py``), and the engine keeps FastTracker
compatibility: frames the scan flags ``needs_host`` are replayed one
frame at a time through a host FastTracker whose per-fish state is
spliced in from the device carry, and the scan resumes from the
corrected carry at the next frame.

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
from ..ops.device_tracker import (_detect_kwargs, carry_from_vec_np,
                                  carry_to_vec, carry_vec_size,
                                  fused_scan_packed, make_aux,
                                  params_from_settings, scan_packed,
                                  unpack_result)
from ..ops.labeling import label_blobs_raw
from .engine import FastTracker, raw_from_blobs
from .tracker import FrameStatistics


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
    ``scan_seconds`` sums the host wall time of the scan calls, each
    ending in the copy of its packed result to the host."""

    CHUNK = 256

    def __init__(self, settings, background: np.ndarray,
                 chunk: int = None, caps: dict = None, device=None):
        self.settings = SettingsView(settings)
        self.device = resolve_device(device)
        self.background = np.asarray(background)
        self.caps = caps
        # host helper: candidate tables and the replay; raises
        # EngineUnsupported outside the base configuration
        self._helper = FastTracker(self.settings, self.background)
        self.P = params_from_settings(self.settings)
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

        # every assist costs a host replay plus a fresh scan launch for
        # the rest of the chunk; past a quarter of at least 64 frames
        # the plain host engine is faster
        self.demote_threshold = 0.25
        self.demote_min_frames = 64
        self.demoted = False
        self._frames_done = 0

        # the carry lives on the host as one packed float32 vector
        # (carry_to_vec layout)
        self._carry_vec = None
        self._buf: list[tuple[int, float, list]] = []

    def _ensure_carry(self, frame: int, time: float):
        if self._carry_vec is None:
            self.start_frame = frame
            F = self.F
            self._carry_vec = carry_to_vec(dict(
                last_x=np.zeros(F), last_y=np.zeros(F),
                last_time=np.zeros(F),
                last_frame=np.full(F, -(10 ** 9), np.float64),
                n_basic=np.zeros(F),
                seen=np.zeros((F, self.P.frame_rate)),
                n_fish=0, start_frame=frame, prev_time=time))

    def _scan(self, launch):
        """Run one scan launch; returns its packed result on the host."""
        t0 = _time.perf_counter()
        vec = launch().cpu().numpy()
        self.scan_seconds += _time.perf_counter() - t0
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

    def _det_packed(self, tables: list):
        """Per-frame candidate tables -> the packed (T, 6B) det array of
        ``scan_packed``: [cx, cy, bcx, bcy, recount, valid], B the
        largest table."""
        B = max(1, max(t.n for t in tables))
        packed = np.zeros((len(tables), 6 * B), np.float32)
        sq = self.P.cm_per_pixel * self.P.cm_per_pixel
        for i, t in enumerate(tables):
            n = t.n
            packed[i, 0 * B:0 * B + n] = t.cx
            packed[i, 1 * B:1 * B + n] = t.cy
            packed[i, 2 * B:2 * B + n] = (t.bx0 + t.bx1 + 1) * 0.5
            packed[i, 3 * B:3 * B + n] = (t.by0 + t.by1 + 1) * 0.5
            packed[i, 4 * B:4 * B + n] = t.recount / sq
            packed[i, 5 * B:5 * B + n] = 1.0
        return packed, B

    def _flush(self):
        buf, self._buf = self._buf, []
        frames = [f for f, _, _ in buf]
        times = [t for _, t, _ in buf]
        self._ensure_carry(frames[0], times[0])
        eng = self._helper
        raws = [raw_from_blobs(blobs, self.background, eng.track_thr,
                               eng.absolute) for _, _, blobs in buf]
        tables = [eng.build_candidates(*raw)[0] for raw in raws]

        i = 0
        while i < len(buf):
            if self._maybe_demote(frames[i], times[i]):
                for k in range(i, len(buf)):
                    self._host_step(frames[k], times[k], raws[k])
                break
            span = len(buf) - i
            packed, B = self._det_packed(tables[i:])
            aux = make_aux(self._carry_vec, times[i:], frames[i:])
            vec = self._scan(lambda: scan_packed(packed, aux, self.P, B,
                                                 device=self.device))
            stop = self._commit_span(frames[i:], vec, span)
            if stop == span:
                break
            j = i + stop
            self._assist(frames[j], times[j], raws[j])
            i = j + 1
        self.end_frame = frames[-1]

    # -- fused raw-frame ingestion ---------------------------------------

    def track_frames(self, frames: np.ndarray, start_frame: int = 0):
        """Detection fused with tracking on the card over a raw frame
        batch, a chunk at a time. Per chunk the frames and one aux vector
        go up and one packed result comes down."""
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
                frames[i:j], bg_dev, aux, self.P, device=self.device,
                **kw))
            stop = self._commit_span(idx[i:j], vec, j - i)
            if stop == j - i:
                i = j
                continue
            k = i + stop
            self._assist(int(idx[k]), float(times[k]), raw_of(k))
            i = k + 1
        self.end_frame = int(idx[-1])
        return self

    def _commit_span(self, frames, vec, span: int) -> int:
        """Commit a scan's frames up to the first flagged one (needs_host,
        or a detect overflow of the fused path) and resume the carry from
        the row before it. Returns the number committed (``span`` when no
        frame is flagged)."""
        hist, carry_rows = unpack_result(vec, span, self.P)
        flags = hist["needs_host"] | hist["detect_overflow"]
        stop = int(np.argmax(flags)) if flags.any() else span
        if stop:
            # n_fish as of the commit horizon, not the chunk's end (the
            # carry's n_fish sits three before its end)
            hist["n_fish"] = np.int32(
                carry_rows[stop - 1][carry_vec_size(self.P) - 3])
            self._carry_vec = carry_rows[stop - 1]
        self._commit_history(frames[:stop], hist, stop)
        self._frames_done += stop
        return stop

    # -- host assist (per-frame replay) ----------------------------------

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

    def _assist(self, frame: int, time: float, raw: tuple):
        """Replay one flagged frame through the host engine and rebuild
        the carry from its state."""
        t0 = _time.perf_counter()
        self._sync_helper_state(frame, time)
        eng = self._helper
        eng.add_frame(frame, time, *raw)
        self.assist_frames.append(frame)
        self._frames_done += 1
        got = self._harvest_host_frame(frame)
        prev = carry_from_vec_np(self._carry_vec, self.P)
        F = self.F
        self._carry_vec = carry_to_vec(dict(
            last_x=eng.last_x[:F], last_y=eng.last_y[:F],
            last_time=eng.last_time[:F],
            last_frame=np.clip(eng.last_frame[:F], -(10 ** 9), None),
            n_basic=eng.n_basic[:F],
            seen=np.concatenate([prev["seen"][:, 1:], got[:, None]], 1),
            n_fish=eng.n_fish, start_frame=self.start_frame,
            prev_time=time))
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
        return self.demoted

    def _host_step(self, frame: int, time: float, raw: tuple):
        """One frame fully on the (already synced) host engine."""
        self._helper.add_frame(frame, time, *raw)
        self._harvest_host_frame(frame)
        self._frames_done += 1

    # -- result harvesting ------------------------------------------------

    def _commit_history(self, frames, hist, stop: int):
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
        if stop:
            self.n_fish = max(self.n_fish, int(hist["n_fish"]))

    def positions(self) -> dict:
        """Dense history arrays: fish_x/fish_y (T, F), fish_seen."""
        return positions_of(self)


def positions_of(tracker) -> dict:
    """Dense (T, F) position history from any history engine
    (FastTracker and DeviceTracker share the history-dict schema)."""
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
    return dict(frames=frames, fish_x=fx, fish_y=fy, fish_seen=seen)


def export_positions(tracker, path) -> None:
    """Position-history npz for the history engines (fast/device)."""
    np.savez_compressed(path, **positions_of(tracker))
