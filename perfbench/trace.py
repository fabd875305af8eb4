"""Spans around the port's layers, the profiler, and their reduction.

With ``--trace 1`` the benchmark's own wrappers record a span around
each call into a layer of the port (``torch.profiler.record_function``,
so that spans and device operations share the profiler's clock):

=============  ==========================================================
span           call
=============  ==========================================================
``apply``      ``YOLOBackend.apply`` (the harness's loop)
``prepare``    ``YOLODetector._prepare`` (a tile's letterbox)
``infer``      ``YOLODetector._infer`` (the forward, its rows to the host)
``forward``    ``YOLODetector.infer_device`` (inside ``infer``)
``postprocess``  ``YOLODetector._postprocess`` (a tile's threshold, NMS)
``merge``      ``detect.yolo.merge_tile_detections``
``blobs``      ``detect.yolo.boxes_to_blobs`` / ``obbs_to_blobs``
``gray``       ``detect.base.bgr_to_gray``
=============  ==========================================================

:func:`reduce` turns the profile into a :class:`Trace`, the one object
every metric reader in ``perfbench/metrics`` reads.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

PREFIX = "perfbench."
# innermost first: an idle gap is charged to the first of these whose
# span covers it
GAP_ORDER = ("forward", "prepare", "postprocess", "merge", "blobs", "gray",
             "infer", "apply")


class Spans:
    """``spans(name)`` is a profiler range when tracing, else nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def wrapped(self, name, fn):
        def call(*a, **k):
            with self(name):
                return fn(*a, **k)
        return call

    def wrap_port(self, detector, det_yolo, det_base) -> list:
        """Wrap the port's layers; returns the functions that undo it."""
        undo = []

        def patch(obj, attr, name):
            old = getattr(obj, attr)
            setattr(obj, attr, self.wrapped(name, old))
            undo.append(lambda: setattr(obj, attr, old))

        patch(detector, "_prepare", "prepare")
        patch(detector, "_infer", "infer")
        patch(detector, "infer_device", "forward")
        patch(detector, "_postprocess", "postprocess")
        patch(det_yolo, "merge_tile_detections", "merge")
        patch(det_yolo, "boxes_to_blobs", "blobs")
        patch(det_yolo, "obbs_to_blobs", "blobs")
        patch(det_base, "bgr_to_gray", "gray")
        return undo[::-1]


def profiler(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(iv: np.ndarray) -> float:
    """Total length of the union of (n, 2) intervals."""
    if len(iv) == 0:
        return 0.0
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = iv[:, 0]
    new = np.concatenate([[True], starts[1:] > ends[:-1]])
    gi = np.cumsum(new) - 1
    lo = starts[new]
    hi = np.zeros(len(lo))
    np.maximum.at(hi, gi, iv[:, 1])
    return float((hi - lo).sum())


@dataclass
class Trace:
    """What one traced window recorded; times in seconds."""
    spans: dict            # name -> (n, 2) array of [start, end]
    device: list           # (name, kind, start, end, launched): kind
    #                        kernel/memcpy/memset, launched the start of
    #                        the host operation that launched it (nan
    #                        where the profiler links none)
    window: tuple          # (start, end) of the traced window
    frames: int            # frames completed in the window
    tiles_per_frame: int
    flops_per_tile: float  # one forward of one tile, from layer shapes
    bytes_per_tile: float
    peak_flops: float      # the card's published dense peak, the dtype's
    peak_bytes_per_s: float
    apply_s: list = field(default_factory=list)  # each frame's apply

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_intervals(self, kinds=None, launched_in=None) -> np.ndarray:
        """(n, 2) [start, end] of the device operations of `kinds`; with
        `launched_in`, only those launched inside a span of that name."""
        spans = self.spans.get(launched_in, np.zeros((0, 2)))
        iv = [(s, e) for _, k, s, e, at in self.device
              if (kinds is None or k in kinds)
              and (launched_in is None
                   or bool(((spans[:, 0] <= at) & (at <= spans[:, 1])).any()))]
        return np.array(iv, np.float64).reshape(-1, 2)

    def device_s(self, kinds=None, launched_in=None) -> float:
        iv = self.device_intervals(kinds, launched_in)
        return float((iv[:, 1] - iv[:, 0]).sum())

    @property
    def busy_s(self) -> float:
        iv = np.clip(self.device_intervals(), *self.window)
        return _union(iv)

    def span_total(self, name) -> float:
        iv = self.spans.get(name, np.zeros((0, 2)))
        return float((iv[:, 1] - iv[:, 0]).sum())

    def breakdown(self) -> dict:
        ops = defaultdict(float)
        for name, _, s, e, _ in self.device:
            ops[name] += e - s
        iv = np.clip(self.device_intervals(), *self.window)
        iv = iv[np.argsort(iv[:, 0])]
        ends = np.concatenate([[self.window[0]],
                               np.maximum.accumulate(iv[:, 1])])
        starts = np.concatenate([iv[:, 0], [self.window[1]]])
        idle = ends < starts
        gaps = defaultdict(float)
        # a sweep over the idle gaps and the host spans: each stretch of
        # a gap goes to the innermost span open over it
        rank = {n: i for i, n in enumerate(GAP_ORDER)}
        marks = [(t, 1, -1) for t in ends[idle]] + \
            [(t, 0, -1) for t in starts[idle]]
        for name, sp in self.spans.items():
            if name in rank:
                marks += [(t, 1, rank[name]) for t in sp[:, 0]]
                marks += [(t, 0, rank[name]) for t in sp[:, 1]]
        marks.sort()
        open_ = [0] * len(GAP_ORDER)
        in_gap, last = 0, None
        for t, opening, r in marks:
            if in_gap and last is not None and t > last:
                owner = next((GAP_ORDER[i] for i, n in enumerate(open_)
                              if n), "loop")
                gaps["host:" + owner] += t - last
            if r < 0:
                in_gap += 1 if opening else -1
            else:
                open_[r] += 1 if opening else -1
            last = t

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def reduce(prof, **kw) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``.

    Each device operation carries the start of the host operation that
    launched it: the profiler links the two by correlation id (a kernel's
    ``linked_correlation_id`` is the ``correlation_id`` of the PyTorch
    operation it ran for), so a kernel belongs to the span its launch
    lay in, whenever the card ran it."""
    events = prof.profiler.kineto_results.events()
    named = defaultdict(list)
    launched_at = {}
    ops = []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:
        name = ev.name()
        s = ev.start_ns() / 1e9
        e = s + ev.duration_ns() / 1e9
        if name.startswith(PREFIX):
            if ev.device_type() != cuda:
                named[name[len(PREFIX):]].append((s, e))
        elif ev.device_type() == cuda:
            kind = "memcpy" if name.startswith("Memcpy") else \
                "memset" if name.startswith("Memset") else "kernel"
            ops.append((name, kind, s, e, ev.linked_correlation_id()))
        elif ev.linked_correlation_id() == 0:
            launched_at[ev.correlation_id()] = s
    device = [(name, kind, s, e, launched_at.get(link, math.nan))
              for name, kind, s, e, link in ops]
    spans_np = {k: np.array(v, np.float64) for k, v in named.items()}
    app = spans_np.get("apply", np.zeros((0, 2)))
    window = (float(app[:, 0].min()), float(app[:, 1].max())) if len(app) \
        else (0.0, 0.0)
    return Trace(spans=spans_np, device=device, window=window, **kw)
