"""Closed loop: live per-frame tracking features streamed to user code.

Counterpart of ``trex_tpu/closed_loop.py`` (the reference's closed-loop
facility, ml/ClosedLoop.{h,cpp}, with the user module
Application/closed_loop.py defining ``request_features()`` and
``update_tracking(...)``, :23-40): after each tracked frame, the user
module receives the selected features (positions, midlines, visual
fields) of every tracked individual. The module is reloaded when its
file's mtime changes; a module that fails to load or raises prints a
warning and the tracking goes on. Visual fields are projected on the
loop's `device` (the card when None).
"""
from __future__ import annotations

import importlib.util
import inspect
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np

FEATURES = ("position", "midline", "visual_field")


@dataclass
class ClosedLoopFrame:
    frame: int
    time: float
    ids: np.ndarray
    positions: Optional[np.ndarray] = None  # (N, 2)
    velocities: Optional[np.ndarray] = None  # (N, 2)
    midlines: Optional[list] = None  # list of (K, 2) or None
    visual_fields: Optional[dict] = None  # id-indexed arrays


def maybe_closed_loop(tracker, settings,
                      device=None) -> Optional["ClosedLoop"]:
    """Activate the live loop when `closed_loop_enable` is set
    (ml/ClosedLoop.h:28 `update_loop`, enabled via closed_loop_enable /
    closed_loop_path in default_config.cpp). Returns None when
    disabled; otherwise a ClosedLoop with the user module from
    `closed_loop_path` loaded if the file exists (missing files warn —
    the loop still runs for programmatic callbacks)."""
    if not settings["closed_loop_enable"]:
        return None
    cl = ClosedLoop(tracker, settings, device=device)
    path = Path(str(settings["closed_loop_path"] or "closed_loop_beta.py"))
    if path.exists():
        cl.load_module(path)
    else:
        print(f"[closed_loop] enabled but module {path} not found; "
              "running without a user module", file=sys.stderr)
    return cl


class ClosedLoop:
    """Collects requested features per frame and invokes the callback."""

    def __init__(self, tracker, settings,
                 callback: Optional[Callable[[ClosedLoopFrame], None]] = None,
                 features: Optional[list[str]] = None, device=None):
        self.tracker = tracker
        self.device = device
        self.settings = settings
        self.callback = callback
        self.features = [f.strip() for f in (features or ["position"])]
        self._module = None
        self._module_path: Optional[Path] = None
        self._module_mtime = 0.0

    # -- user module loading (ModuleProxy behavior) ----------------------
    def load_module(self, path):
        self._module_path = Path(path)
        self._reload_if_changed(force=True)

    def _reload_if_changed(self, force=False):
        p = self._module_path
        if p is None:
            return
        # a half-written file mid-save (or a user syntax error) must
        # not kill the tracking loop (ClosedLoop.cpp:50 catches and
        # warns); keep the previous module on any failure
        try:
            mtime = p.stat().st_mtime
            if not force and mtime == self._module_mtime:
                return
            spec = importlib.util.spec_from_file_location(
                "trex_closed_loop", p)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except Exception as e:
            print(f"[closed_loop] cannot (re)load {p}: {e}",
                  file=sys.stderr)
            return
        self._module = mod
        self._module_mtime = mtime
        if hasattr(mod, "request_features"):
            feats = mod.request_features()
            if isinstance(feats, (list, tuple, set)):
                parts = [str(f) for f in feats]
            else:
                parts = str(feats).split(",")
            self.features = [f.strip() for f in parts if f.strip()]

    # -- per-frame update -------------------------------------------------
    def update(self, frame: int):
        self._reload_if_changed()
        tracker = self.tracker
        ids, pos, vel, midlines = [], [], [], []
        for fid, ind in sorted(tracker.individuals.items()):
            b = ind.basic_stuff(frame)
            if b is None:
                continue
            ids.append(fid)
            pos.append(b.centroid.pos)
            vel.append((b.centroid.vx, b.centroid.vy))
            if "midline" in self.features:
                p = ind.posture_stuff(frame)
                midlines.append(
                    np.asarray(p.midline.segments) if p and p.midline
                    else None)
        data = ClosedLoopFrame(
            frame=frame, time=tracker.frame_times.get(frame, frame),
            ids=np.asarray(ids, np.int64),
            positions=np.asarray(pos) if pos else np.zeros((0, 2)),
            velocities=np.asarray(vel) if vel else np.zeros((0, 2)),
            midlines=midlines if "midline" in self.features else None,
        )
        if "visual_field" in self.features and ids:
            from .track.visual_field import compute_visual_fields

            res = compute_visual_fields(tracker, frame, self.settings,
                                        device=self.device)
            if res is not None:
                vf_ids, fields = res
                data.visual_fields = {
                    fid: {k: v[i] for k, v in fields.items()}
                    for i, fid in enumerate(vf_ids)}
        if self.callback:
            self.callback(data)
        if self._module is not None and hasattr(self._module,
                                                "update_tracking"):
            # reference user modules define update_tracking() with NO
            # parameters and read injected globals (closed_loop.py:26)
            fn = self._module.update_tracking
            try:
                takes_arg = len(inspect.signature(
                    fn).parameters) >= 1
            except (TypeError, ValueError):
                takes_arg = True
            try:
                if takes_arg:
                    fn(data)
                else:
                    self._module.frame_data = data
                    fn()
            except Exception as e:
                print(f"[closed_loop] update_tracking failed: {e}",
                      file=sys.stderr)
        return data
