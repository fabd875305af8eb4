#!/usr/bin/env python3
"""Smoke run of the PyTorch port (trex_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each raising on failure:

1. Build every CUDA kernel of the port from ``trex_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together) and the host labeler from
   ``trex_tpu_torch/native`` (``g++``, beside them), and hold each kernel
   against its plain PyTorch version: the labeler on random masks
   (densities 0.1 / 0.35 / 0.6, widths that are not a multiple of 128,
   S-shapes that span the frame) and on :func:`hard_masks` (masks that
   break tiled labellers), the 3x3 minimum stencil on random int32 tiles
   (a 3x3 tile, sizes that are not multiples of 32 or 128) and on
   :func:`hard_tiles`: outputs must be equal (torch.equal).
2. Pixel-grid detection at full size: ``detect_batch(use_pallas=True)``
   on 32 synthetic frames of 1024^2 with 256 fish. Equal to the same
   call through the plain labeler, and slot for slot equal to the
   run-based ``detect_batch_runs`` on every frame where neither
   overflows. The CUDA labeler's launch count must have moved.
3. Propagation labelling at full size: ``label_components(mask,
   use_pallas=True)`` on the 32 detection masks of phase 2, one stencil
   launch per step. Equal to ``label_components_vmem`` and to the plain
   path; the stencil's launch count must have moved.
4. Device tracking chunk at full size: ``track_video_device`` on 64
   synthetic frames of 1024^2 with 256 fish (the base configuration:
   approximate matching, no history split). No detect overflow,
   0 < n_fish <= 256, and the packed result of ``fused_scan_packed``
   on the same chunk equals the dict result. On a small chunk the card
   gives the same integer outputs as the port's CPU path (which the
   tests hold to the JAX package).
5. The product engine on the same chunk: ``DeviceTracker.track_frames``
   with the host replay of the frames the scan flags. Every frame has a
   history entry, two runs agree, the frames before the first flagged
   one equal phase 4's and the first assist is that frame. Held to the
   port's host FastTracker under ``tests/test_device_engine.py::
   _compare_history``'s rule (every host assignment in the device
   history, x and y within 1e-4) on a sparse full-size chunk (64 fish)
   and on two two-fish scenes that replay 21 frames and demote after 32
   assists, as the JAX twin does. On the 256-fish chunk the frames
   where the history departs from the host engine are reported, not
   held: the JAX package's DeviceTracker departs from its FastTracker
   at that density as well (``ROADMAP.md`` C1). On a small chunk that
   replays frames, the card equals the port's CPU path (which the tests
   hold to the JAX package's DeviceTracker).
6. The product-default configuration (``auto-split``): the settings of
   phases 4-5 with ``match_mode=automatic`` (the auction with its
   certificate) and ``track_do_history_split`` (the split on the card).
   ``track_video_device`` on the 64-frame chunk, with the frames it
   flags, the auction rounds a frame, the split targets a frame and the
   CUDA launches a frame (in all, in the auction, in the split; over
   frames 24-39, resumed from the carry of frame 23);
   ``DeviceTracker.track_frames`` on the chunk's first 32 frames with its
   assists, the frames its scans covered and the replay seconds; the
   frames where it departs from the port's FastTracker
   under the same settings are reported (``ROADMAP.md`` C1). Held to the
   host FastTracker: a sparse full-size chunk (64 fish), a two-fish
   crossing whose auction is flagged and replayed, and two fish that
   merge into one blob, split on the card with no assist. On a small
   chunk the card gives the port's CPU path's integer outputs.
7. Posture on the card (``posture``): the chunk of phase 4 with
   ``calculate_posture`` as ``bench.py``'s posture variant sets it
   (threshold 15, outline resample 0.5), in the base configuration and
   in the product default. ``fused_scan_packed`` over the 64 frames with
   and without the posture pass: frames per second, active lanes and the
   share with a posture, the frames posture flags by cause (a split
   child, a blob too big for the crop, a capacity overflow), the most
   escalation rounds and trace points of any lane, the CUDA launches and
   device time inside the ``trex.posture`` range, and the pass's peak
   memory. ``DeviceTracker.track_frames`` over 64 frames (base) and 16
   (product default) with its assists, frames scanned, replay seconds
   and postures. Held to the port's FastTracker on the card, under
   ``tests/test_device_posture.py::_compare_posture``'s rule (equal
   ``ok``, length within 0.05 px, angle within 1e-3 rad): the
   asymmetric four-fish scene of that file on the fused path (no assist)
   and on the blob path, whose export has postures. On a small chunk the
   card gives the port's CPU path's integer outputs and posture flags,
   the lengths and angles within the same rule.
8. Speed decay (``decay``): the chunk of phase 4 with
   ``track_speed_decay`` 0.7 (the reference's golden-fixture setting) in
   the base configuration and the product default.
   ``track_video_device`` over the 64 frames with its frames per second,
   the frames it flags and how many of them a broken motion window
   flagged, and the CUDA launches a frame over frames 24-31 with and
   without decay; ``DeviceTracker.track_frames`` over 32 frames (base
   and product default) with its assists, frames scanned and replay
   seconds. On small chunks that replay frames the card gives the port's
   CPU path's integer outputs and flags, the carry's motion window and
   accumulated walk bit for bit, and the same DeviceTracker history;
   the DeviceTracker is held to the port's FastTracker on the sparse
   64-fish chunk of phase 5 (``_compare_history``'s rule).
9. Archive mode (``archive``): ``DeviceTracker(keep_individuals=True)``
   on the blob path (``add_frame_blobs`` of host-labelled frames) over
   the chunk of phase 4 with posture (base configuration): frames per
   second, host seconds a frame besides the scans and the labelling,
   the seconds of ``build_individuals``, the individuals and posture
   records. Held to the port's ``FastTracker(keep_individuals=True)``
   under ``tests/test_archive.py::_assert_individuals_equal``'s rule and
   with equal posture records on the sparse 64-fish chunk and on the
   asymmetric scene; on the 256-fish chunk the individuals that depart
   are reported (``ROADMAP.md`` C1).
10. The product path (``product``), through the entry points a user
    calls: the port's ``Segmenter`` converts ``synth_frames(64)`` (256
    fish at 1024^2, served by an in-memory ``VideoSource``: the machine
    has no OpenCV) under the user's default tracking settings
    (:func:`product_settings`) with ``detect_engine=device`` and
    ``track_engine=device`` into a .pv, held frame for frame (masks and
    pixel bytes) to the same conversion with the host labeler; the
    frames that overflowed the detector's caps are counted, and all of
    them overflowing fails. The port's ``trex`` CLI
    (``cli.trex.main``) tracks the .pv with ``-track_engine device
    -auto_quit``: the DeviceTracker, not demoted, writes the npz files
    and the .results. On the sparse 64-fish chunk ``-track_engine auto``
    picks the card's engine, and its npz files and .results equal byte
    for byte those of ``auto`` on the CPU (the host FastTracker); on the
    256-fish chunk the individuals that depart from the FastTracker's
    are reported (``ROADMAP.md`` C1). The CLI also tracks the scene over
    96 frames, where the DeviceTracker demotes to the host once past 64.
    Frames per second of the conversion and of the CLI's track task,
    with the seconds of detection, scans, replay, export and .results,
    the assists, frames scanned, overflowed frames and output bytes.
11. The object Tracker (``object``) under the registry's default tracking
    settings (:func:`object_settings`: only the conversion's encoding,
    background, clock, scale, ``detect_engine=device`` and
    ``track_engine=auto``), which both fast engines refuse: the port's
    ``Segmenter`` converts ``synth_frames(64)`` (256 fish at 1024^2) with
    detection on the card, and ``auto`` picks the object Tracker for the
    reason it records (``track_threshold == 0``); the CLI's track task
    (``-track_engine auto -auto_quit`` with output_statistics,
    output_heatmaps and gui_show_memory_stats) writes the npz files,
    statistics, heatmaps and .results; ``-load`` restores that .results
    (same identities, frames and float32 positions), and a second
    ``-load`` reproduces the first's npz and .results bytes. On the sparse
    64-fish chunk under :func:`product_settings` (which both engines
    accept) ``-track_engine object`` and ``fast`` write per-fish npz files
    equal bit for bit but for the angle columns, which the JAX package's
    engines also write from different sums and which are held within
    :data:`ANGLE_BOUNDS` (``ROADMAP.md`` C5), and .results equal but for
    the recorded ``track_engine``. Frames per second of the conversion
    and the track task, ``adding_seconds``, ``posture_seconds`` and
    ``loading_seconds`` a frame from ``FrameStatistics``, the detection
    thread's seconds, individuals and output bytes.
12. Report: frames per second of phases 2-11, the replay's assist frames
   and seconds, the card's name and power limit, and one JSON line with
    every kernel's launches on its path, error against its plain
    version, time, bound, the plain version's time and the nearest
    library call's time; for B1 also the device time of each of its
    passes under ``torch.profiler``. A kernel's ``ms`` is the median of
    single calls, each synchronised, so it holds the wrapper's host time
    before the launch; ``ms_back_to_back`` is the time per call over 20
    calls launched back to back, which hides that host time. The last
    line is ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without CUDA or without the
trex_tpu_torch package beside it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

N_FISH = 256
SIZE = 1024
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
# H100 SXM float32 peak outside the tensor cores, taken for the labeler's
# 32-bit integer compares
INT32_OPS_PER_S = 67e12


def synth_frames(n_frames, n_fish=N_FISH, size=SIZE, seed=0):
    """Synthetic video of `n_fish` dark elongated blobs on a bright
    background; every fish has its own slightly asymmetric stamp and
    fish reflect at the walls."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(30, size - 30, (n_fish, 2))
    vel = rng.normal(0, 2.0, (n_fish, 2))
    stamps = []
    for i in range(n_fish):
        w = int(13 + (i % 5))
        h = int(8 + (i % 3))
        st = np.zeros((h, w), np.uint8)
        st[2:h - 2, 1:w - 1] = 90
        st[3:h - 3, 0:w] = 110
        st[2, w - 3:w - 1] = 0
        st[h - 3, 1:3] = 70
        stamps.append(st)
    bg = np.full((size, size), 200, np.uint8)
    frames = []
    for _ in range(n_frames):
        img = bg.copy()
        vel += rng.normal(0, 0.6, vel.shape)
        np.clip(vel, -4, 4, out=vel)
        pos += vel
        over = (pos < 20) | (pos > size - 25)
        vel[over] *= -1
        pos = np.clip(pos, 20, size - 25)
        for k, (x, y) in enumerate(pos):
            st = stamps[k]
            xi, yi = int(x), int(y)
            region = img[yi:yi + st.shape[0], xi:xi + st.shape[1]]
            np.minimum(region, 200 - st[:region.shape[0], :region.shape[1]],
                       out=region)
        frames.append(img)
    return bg, np.stack(frames)


def track_settings(n_fish=N_FISH):
    """The benchmark's tracking settings in the base configuration."""
    return {
        "track_max_individuals": n_fish,
        "track_max_speed": 300,
        "cm_per_pixel": 1.0,
        "frame_rate": 25,
        "track_threshold": 20,
        "track_threshold_is_absolute": False,
        "track_background_subtraction": True,
        "track_size_filter": [[20, 400]],
        "calculate_posture": False,
        "match_mode": "approximate",
        "track_do_history_split": False,
    }


TRACK_CAPS = dict(max_runs=8192, max_pixels=1 << 17, max_blobs=320,
                  max_child_runs=8192, max_children=320)


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def sync():
    import torch

    torch.cuda.synchronize()


def time_ms(fn, iters=10, warmup=2):
    """Median milliseconds of `fn()` on the card (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    sync()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms_back_to_back(fn, calls=20, warmup=2):
    """Milliseconds per call of `fn()` on the card over `calls` calls
    launched back to back between two CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


PORT_KERNELS = ("ccl_", "neighbor_min")


def kernel_split(fn, calls=10):
    """Device milliseconds per call of `fn()` spent in each of the port's
    own CUDA kernels (names with a prefix of PORT_KERNELS), under
    torch.profiler over `calls` warm calls: {kernel: ms}. Empty when
    the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        sync()
    out = {}
    for e in prof.key_averages():
        name = kernel_name(e.key)
        if e.device_type == DeviceType.CUDA and name.startswith(PORT_KERNELS):
            out[name] = out.get(name, 0.0) + device_us(e) / 1e3 / calls
    return out


def device_us(e) -> float:
    """Self device time of a torch.profiler row, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


def kernel_name(key):
    """The function name of a demangled CUDA kernel name
    (``(anonymous namespace)::ccl_tile(unsigned char const*, ...)`` and
    ``void (anonymous namespace)::f<2>(...)`` give ``ccl_tile``, ``f<2>``)."""
    head = key.split("(anonymous namespace)::")[-1]
    return head.split("(")[0].strip()


def detection_masks(dev, n_frames=32):
    """`n_frames` frames of :func:`synth_frames` on `dev` and their
    pixel-grid detection masks (threshold 15 below the background, as
    the bench's ``detect_batch`` call): (frames as numpy, frames,
    background, (n_frames, SIZE, SIZE) bool masks), the last three on
    `dev`. The labeler's input on its path."""
    import torch

    bg, frames = synth_frames(n_frames)
    fr = torch.as_tensor(frames, device=dev)
    bgt = torch.as_tensor(bg, device=dev)
    mask = ((bgt.to(torch.int16)[None] - fr.to(torch.int16)) >= 15) \
        & (fr > 0)
    return frames, fr, bgt, mask


def stencil_tiles(mask):
    """The stencil's input on its path for (N, H, W) `mask`: the masks'
    initial labels (y * W + x, INACTIVE on background) padded by one row
    and column of INACTIVE, (N, H + 2, W + 2) int32."""
    import torch
    import torch.nn.functional as F

    from trex_tpu_torch.ops.cc_device import INACTIVE

    _, h, w = mask.shape
    lin = torch.arange(h * w, dtype=torch.int32,
                       device=mask.device).reshape(1, h, w)
    return F.pad(torch.where(mask, lin, INACTIVE), (1, 1, 1, 1),
                 value=INACTIVE)


def s_shape_mask(h, w, turns):
    """A serpentine that spans the frame: `turns` horizontal bars joined
    alternately at the right and the left edge."""
    m = np.zeros((h, w), bool)
    ys = np.linspace(1, h - 2, turns).astype(int)
    for i, y in enumerate(ys):
        m[y, 1:w - 1] = True
        if i + 1 < len(ys):
            x = w - 2 if i % 2 == 0 else 1
            m[y:ys[i + 1] + 1, x] = True
    return m


def staircase(m, yc, xc, flip):
    """Draw into `m` a staircase of 3-pixel steps, each joined to the
    next only through a diagonal, whose middle joint is the diagonal
    from pixel (yc - 1, xc - 1) to (yc, xc), or, `flip`ped, from
    (yc - 1, xc) to (yc, xc - 1)."""
    h, w = m.shape
    for i in range(-4, 4):
        y = yc + i
        x = xc - 3 - 3 * i if flip else xc + 3 * i
        if 0 <= y < h:
            m[y, max(x, 0):max(min(x + 3, w), 0)] = True


def hard_masks():
    """Masks that break tiled labellers, as [(name, (B, H, W) bool)].

    Frames of 70 x 300 (with the labeler's 32 x 256 tiles: a height that
    is no multiple of the tile's, two inner tile rows, one inner tile
    column): a checkerboard, whose components are linked only
    diagonally; staircases whose diagonal joints lie on the tile corners
    and on tile rows and columns between them, both diagonals; one-pixel
    vertical lines through every tile row, on and beside the tile
    columns; an all-foreground frame (one component, label 0); an
    all-background frame; a random frame. Then H = 1, W = 1, widths
    W = 16 (r + 1) + r, i.e. W = r (mod 16), for r = 1 .. 15, and a batch
    of frames of one tile each (20 x 200: random, checkerboard, all
    foreground), which the labeler finishes in its tile pass."""
    rng = np.random.default_rng(7)
    h, w = 70, 300
    yy, xx = np.indices((h, w))
    stairs = np.zeros((h, w), bool)
    staircase(stairs, 32, 256, flip=False)  # joints on the tile corners
    staircase(stairs, 64, 256, flip=True)
    # joints on a tile column between two corners, and on a tile row
    for yc, xc, flip in ((16, 256, True), (48, 256, False), (32, 100, False),
                         (64, 150, True)):
        staircase(stairs, yc, xc, flip)
    lines = np.zeros((h, w), bool)
    lines[:, [0, 3, 100, 255, 256, 299]] = True
    out = [("checkerboard", (yy + xx) % 2 == 0),
           ("staircases", stairs),
           ("vertical_lines", lines),
           ("all_foreground", np.ones((h, w), bool)),
           ("all_background", np.zeros((h, w), bool)),
           ("random_70x300", rng.random((h, w)) < 0.45),
           ("h1", rng.random((1, w)) < 0.5),
           ("w1", rng.random((h, 1)) < 0.5)]
    out = [(name, m[None]) for name, m in out]
    for r in range(1, 16):
        out.append((f"w_mod16_{r}",
                    rng.random((1, 40, 16 * (r + 1) + r)) < 0.5))
    one = (slice(0, 20), slice(0, 200))
    out.append(("one_tile", np.stack([rng.random((20, 200)) < 0.45,
                                      (yy[one] + xx[one]) % 2 == 0,
                                      np.ones((20, 200), bool)])))
    return out


def hard_tiles():
    """Tiles that break the stencil's strip sweep, as [(name, (N, H, W)
    int32, offset)]: widths W = 0 .. 3 (mod 4) (vector widths 2 and 1),
    a height below one strip, and a tile to be laid `offset` int32
    elements past an aligned address (an unaligned view, which takes the
    scalar width)."""
    rng = np.random.default_rng(8)

    def rand(*shape):
        return rng.integers(-2 ** 31, 2 ** 31 - 1, shape, dtype=np.int32)

    out = [(f"w_mod4_{r}", rand(2, 37, 64 + r), 0) for r in range(4)]
    out.append(("h_below_strip", rand(3, 5, 130), 0))
    out.append(("unaligned_view", rand(2, 33, 130), 1))
    return out


def on_card(a, dev, offset=0):
    """Tensor of numpy array `a` on `dev`, contiguous, starting `offset`
    elements past the start of its allocation."""
    import torch

    t = torch.as_tensor(a)
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=dev)
    buf[offset:] = t.reshape(-1).to(dev)
    return buf[offset:].view(t.shape)


def phase_kernels(dev, report):
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from trex_tpu_torch import kernels
    from trex_tpu_torch.ops import labeling
    from trex_tpu_torch.ops.cc_device import (label_components_plain,
                                              label_components_vmem,
                                              neighbor_min,
                                              neighbor_min_plain)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(labeling.build)
        took = kernels.build(verbose=True)
        host.result()
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = took
    rng = np.random.default_rng(0)
    cases = [rng.random((4, 517, 1000)) < d for d in (0.1, 0.35, 0.6)]
    cases.append(rng.random((2, 1024, 1024)) < 0.35)
    cases.append(np.stack([s_shape_mask(1024, 1000, 64),
                           s_shape_mask(1024, 1000, 300)]))
    cases.append(s_shape_mask(333, 1021, 41)[None])
    cases = [(f"random_{tuple(m.shape)}", m) for m in cases] + hard_masks()
    for name, m in cases:
        mt = torch.as_tensor(m)
        got = label_components_vmem(mt.to(dev))
        sync()
        ref = label_components_plain(mt.to(dev))
        check(torch.equal(got, ref),
              f"ccl kernel != plain on the {name} mask {tuple(m.shape)}")
    shapes = [(1, 3, 3), (2, 1, 7), (3, 67, 130), (4, 517, 1000),
              (1, 1026, 1026), (2, 1031, 999)]
    tiles = [(f"random_{shape}", rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                              dtype=np.int32), 0)
             for shape in shapes] + hard_tiles()
    for name, t, offset in tiles:
        got = neighbor_min(on_card(t, dev, offset))
        sync()
        check(torch.equal(got.cpu(), neighbor_min_plain(torch.as_tensor(t))),
              f"neighbor_min kernel != plain on the {name} tile {t.shape}")
    print(f"phase 1 ok: kernels and host labeler built in "
          f"{report['build_s']:.1f} s, {len(cases)} mask sets equal to "
          f"the plain labeler, {len(tiles)} tile sets equal to the plain "
          "stencil", flush=True)


def phase_detect(dev, report, kern):
    import torch

    from trex_tpu_torch import kernels
    from trex_tpu_torch.ops.cc_device import (label_components_plain,
                                              label_components_vmem)
    from trex_tpu_torch.ops.device_pipeline import detect_batch
    from trex_tpu_torch.ops.runcc import detect_batch_runs

    frames, fr, bgt, mask = detection_masks(dev)
    kw = dict(threshold=15, absolute=False, track_threshold=20,
              max_blobs=256)
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    grid = detect_batch(fr, bgt, use_pallas=True, device=dev, **kw)
    sync()
    first_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(launches["ccl"] > 0, "detect_batch(use_pallas=True) never "
          "launched the ccl kernel")

    plain = detect_batch(fr, bgt, use_pallas=False, device=dev, **kw)
    for k in ("valid", "count", "track_count"):
        check(torch.equal(grid[k], plain[k]), f"detect_batch {k}: kernel "
              "path != plain labeler path")
    v = grid["valid"]
    for k in ("cx", "cy"):
        check(torch.equal(grid[k][v], plain[k][v]), f"detect_batch {k}")
        check(bool(torch.isfinite(grid[k][v]).all()), f"non-finite {k}")

    runs = detect_batch_runs(fr, bgt, detect_threshold=15,
                             detect_absolute=False, track_threshold=20,
                             track_absolute=False, max_runs=8192,
                             max_pixels=1 << 17, max_blobs=256,
                             max_child_runs=8192, max_children=256,
                             device=dev)
    d = runs["det"]
    compared = 0
    for b in range(frames.shape[0]):
        n = int(d["n_blobs"][b])
        if bool(runs["overflow"][b]) or n >= 256:
            continue
        compared += 1
        check(int(v[b].sum()) == n, f"frame {b}: blob counts differ")
        cnt = d["count"][b, :n]
        for key, ref in (("count", cnt),
                         ("track_count", d["track_count"][b, :n]),
                         ("cx", d["sum_x"][b, :n] / cnt),
                         ("cy", d["sum_y"][b, :n] / cnt)):
            check(torch.equal(grid[key][b, :n], ref),
                  f"frame {b}: pixel-grid {key} != run-based")
    check(compared > 0, "no frame without overflow to compare")

    # kernel timing at the main path's shape, against its plain version
    got = label_components_vmem(mask)
    ref = label_components_plain(mask)
    err = int((got.long() - ref.long()).abs().max())
    check(err == 0, "ccl kernel != plain on the detection masks")
    ms = time_ms(lambda: label_components_vmem(mask), iters=20)
    ms_b2b = time_ms_back_to_back(lambda: label_components_vmem(mask))
    passes = kernel_split(lambda: label_components_vmem(mask))
    plain_ms = time_ms(lambda: label_components_plain(mask), iters=3,
                       warmup=1)
    npix = mask.numel()
    bytes_moved = npix * (1 + 4)        # mask read once, labels written once
    ops = npix * 8                      # one test per neighbour direction
    b_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    b_ops = ops / INT32_OPS_PER_S * 1e3
    det_ms = time_ms(lambda: detect_batch(fr, bgt, use_pallas=True,
                                          device=dev, **kw), iters=5)
    report["detect"] = dict(frames=32, size=SIZE, fish=N_FISH,
                            first_call_s=first_s, ms=det_ms,
                            fps=32 / (det_ms / 1e3),
                            frames_compared_with_runs=compared)
    kern.append({
        "name": "ccl_label",
        "route": "cuda",
        "source": "trex_tpu_torch/csrc/ccl.cu",
        "replaces": "trex_tpu/ops/cc_device.py:188",
        "launches": launches["ccl"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
        "library_note": "no single PyTorch call computes these labels",
        "shape": list(mask.shape),
        "ms_back_to_back": ms_b2b,
        "passes_ms": passes or "not measured",
    })
    print(f"phase 2 ok: pixel-grid detection {report['detect']['fps']:.1f} "
          f"frames/s, {compared}/32 frames equal to run-based slot for slot",
          flush=True)


def phase_label(dev, report, kern):
    import torch
    import torch.nn.functional as F

    from trex_tpu_torch import kernels
    from trex_tpu_torch.ops.cc_device import (label_components,
                                              label_components_vmem,
                                              neighbor_min,
                                              neighbor_min_plain)

    mask = detection_masks(dev)[3]
    label_components(mask[:1], use_pallas=True)  # warm-up
    sync()
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = label_components(mask, use_pallas=True)
    sync()
    call_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    check(launches["neighbor_min"] > 0, "label_components(use_pallas="
          "True) never launched the neighbor_min kernel")
    check(torch.equal(got, label_components_vmem(mask)),
          "label_components(use_pallas=True) != label_components_vmem")
    check(torch.equal(got, label_components(mask)),
          "label_components(use_pallas=True) != its plain path")
    check(int((got >= 0).sum()) == int(mask.sum()), "labels lost pixels")

    # the stencil on tiles of the shape and values the labelling gives
    # it: the whole batch, and one frame
    tiles = stencil_tiles(mask)
    out = {}
    for name, t in (("batch", tiles), ("frame", tiles[:1].contiguous())):
        ref = neighbor_min_plain(t)
        err = int((neighbor_min(t).long() - ref.long()).abs().max())
        check(err == 0, f"neighbor_min kernel != plain on the {name} tile")
        # bytes: each input element read once, each output written once;
        # operations: 8 minimums per element (9 values)
        b_bytes = 2 * 4 * t.numel() / HBM_BYTES_PER_S * 1e3
        b_ops = 8 * t.numel() / INT32_OPS_PER_S * 1e3
        td = t.double()
        out[name] = dict(
            shape=list(t.shape), max_abs_err=err,
            ms=time_ms(lambda: neighbor_min(t), iters=20),
            ms_back_to_back=time_ms_back_to_back(lambda: neighbor_min(t)),
            plain_ms=time_ms(lambda: neighbor_min_plain(t), iters=20),
            library_ms=time_ms(lambda: -F.max_pool2d(-td, 3, 1, 1),
                               iters=20),
            bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations")
    report["label"] = dict(frames=32, size=SIZE, call_s=call_s,
                           steps=launches["neighbor_min"],
                           stencil_one_frame=out["frame"])
    kern.append({
        "name": "neighbor_min",
        "route": "cuda",
        "source": "trex_tpu_torch/csrc/neighbor_min.cu",
        "replaces": "trex_tpu/ops/cc_device.py:56",
        "launches": launches["neighbor_min"],
        **{k: out["batch"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")},
        "library_note": "nearest call: -max_pool2d(-x.double(), 3, 1, 1), "
                        "zero-padded, not wrapped",
        "shape": out["batch"]["shape"],
        "ms_back_to_back": out["batch"]["ms_back_to_back"],
    })
    print(f"phase 3 ok: label_components(use_pallas=True) "
          f"{call_s * 1e3:.1f} ms, {launches['neighbor_min']} steps, equal "
          "to the ccl kernel and the plain path", flush=True)


def phase_track(dev, report):
    import torch

    from trex_tpu_torch.ops.device_tracker import (
        _carry_to_vec, _detect_kwargs, _init_carry, frame_times,
        fused_scan_packed, make_aux, params_from_settings,
        track_video_device, unpack_result)
    from trex_tpu_torch.ops.runcc import detect_batch_runs

    settings = track_settings()
    bg, frames = synth_frames(64)
    fr = torch.as_tensor(frames, device=dev)
    bgt = torch.as_tensor(bg, device=dev)
    t0 = time.perf_counter()
    hist = track_video_device(fr, bgt, settings, device=dev, **TRACK_CAPS)
    sync()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = track_video_device(fr, bgt, settings, device=dev, **TRACK_CAPS)
    sync()
    track_s = time.perf_counter() - t0
    # the detection share of the chunk, on its own
    t0 = time.perf_counter()
    detect_batch_runs(fr, bgt, device=dev,
                      **_detect_kwargs(settings, TRACK_CAPS))
    sync()
    detect_s = time.perf_counter() - t0
    check(not bool(hist["detect_overflow"].any()), "detect overflow")
    n_fish = int(hist["n_fish"])
    check(0 < n_fish <= N_FISH, f"n_fish {n_fish}")
    for k in ("fish_x", "fish_y", "fish_prob", "carry_vec"):
        check(bool(torch.isfinite(hist[k]).all()), f"non-finite {k}")

    P = params_from_settings(settings)
    T = frames.shape[0]
    carry0 = _carry_to_vec(_init_carry(P, 0, 0.0, device="cpu")).numpy()
    aux = make_aux(carry0, frame_times(T, 25.0), np.arange(T))
    packed = fused_scan_packed(fr, bgt, aux, P, device=dev,
                               **_detect_kwargs(settings, TRACK_CAPS))
    h, rows = unpack_result(packed, T, P)
    for k in ("fish_x", "fish_y", "fish_seen", "fish_row", "fish_prob",
              "n_assigned", "needs_host", "detect_overflow"):
        check(np.array_equal(h[k], hist[k].cpu().numpy()),
              f"fused_scan_packed {k} != track_video_device")
    check(np.array_equal(rows, hist["carry_vec"].cpu().numpy()),
          "fused_scan_packed carry rows != track_video_device")

    # small chunk: the card against the port's CPU path
    sbg, sframes = synth_frames(16, n_fish=24, size=192, seed=3)
    small = track_settings(24)
    caps = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
                max_child_runs=1024, max_children=64)
    g = track_video_device(sframes, sbg, small, device=dev, **caps)
    c = track_video_device(sframes, sbg, small, device="cpu", **caps)
    for k in ("fish_row", "fish_seen", "needs_host", "n_assigned",
              "n_fish", "fish_x", "fish_y"):
        check(np.array_equal(g[k].cpu().numpy(), c[k].numpy()),
              f"small chunk {k}: card != CPU")
    report["track"] = dict(frames=T, size=SIZE, fish=N_FISH, n_fish=n_fish,
                           first_call_s=first_s, s=track_s,
                           detect_s=detect_s, fps=T / track_s,
                           needs_host_frames=int(hist["needs_host"].sum()),
                           assigned=int(hist["n_assigned"].sum()))
    print(f"phase 4 ok: tracking chunk {report['track']['fps']:.1f} "
          f"frames/s, n_fish {n_fish}", flush=True)
    return bg, frames, hist


def auto_settings(n_fish=N_FISH, **over):
    """The product-default tracking configuration: track_settings with
    the optimal matcher and the history split."""
    return dict(track_settings(n_fish), match_mode="automatic",
                track_do_history_split=True, **over)


def graded_stamp(img, x, y, w=12, h=7, depth=110):
    """A fish with a darker core (``tests/test_device_split.py``'s
    stamp): threshold escalation separates two that overlap."""
    yy, xx = np.mgrid[0:h, 0:w]
    e = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
    st = np.where(e <= 1.0, (depth * (1.0 - e * 0.75)).astype(int), 0)
    region = img[y:y + h, x:x + w]
    lim = (200 - st[:region.shape[0], :region.shape[1]]).astype(np.uint8)
    np.minimum(region, lim, out=region)


def auto_pair_frames(kind):
    """Two fish in 256^2. ``x_crossing``: two fish of 10x6 px approach
    on one row and step past each other to mirrored places above and
    below it, so that both assignments of frame 10 are worth the same
    and the auction defers it. ``merge``: two graded fish of different
    shape merge at frame 11 and stay one blob, which the card splits."""
    frames = []
    for f in range(24 if kind == "x_crossing" else 40):
        img = np.full((256, 256), 200, np.uint8)
        if kind == "x_crossing":
            k = f - 10
            pos = [(100 + 2 * f, 100), (151 - 2 * f, 100)] if k < 0 \
                else [(125 + 2 * k, 92), (125 - 2 * k, 107)]
            for x, y in pos:
                img[y:y + 6, x:x + 10] = 80
        else:
            graded_stamp(img, 121 - max(0, 12 - f), 100)
            graded_stamp(img, 129 + max(0, 12 - f), 102, w=13, depth=100)
        frames.append(img)
    return np.full((256, 256), 200, np.uint8), np.stack(frames)


def launches_by_range(fn, ranges):
    """Run `fn()` under torch.profiler; returns (its result, the CUDA
    kernels it launched, {range: kernels launched inside that
    torch.profiler.record_function range}, {range: their device ms}).
    The counts are None when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    total = 0
    per = dict.fromkeys(ranges, 0)
    ms = dict.fromkeys(ranges, 0.0)
    for e in prof.events():
        # a range's own span on the device timeline is no launch
        ks = [kk for kk in e.kernels if kk.name not in per]
        if not ks:
            continue
        total += len(ks)
        p = e.cpu_parent
        while p is not None and p.name not in per:
            p = p.cpu_parent
        if p is not None:
            per[p.name] += len(ks)
            ms[p.name] += sum(kk.duration for kk in ks) / 1e3
    if not total:
        return out, None, dict.fromkeys(ranges), dict.fromkeys(ranges)
    return out, total, per, ms


def pair_frames(kind):
    """Two fish of 10x6 px in 256^2 (``tests/test_torch_engine.py``'s
    scenes): ``merge_heavy`` crosses once over 60 frames, ``assist_storm``
    merges every other frame for 80 frames."""
    frames = []
    for f in range(60 if kind == "merge_heavy" else 80):
        if kind == "merge_heavy":
            dx = max(0, abs(30 - f) - 10)
            pos = [(120 - dx, 100), (130 + dx, 100)]
        else:
            pos = [(60 + f, 100), (66 + f if f % 2 else 74 + f, 100)]
        img = np.full((256, 256), 200, np.uint8)
        for x, y in pos:
            img[y:y + 6, x:x + 10] = 80
        frames.append(img)
    return np.full((256, 256), 200, np.uint8), np.stack(frames)


def host_track(frames, bg, settings):
    """The port's host FastTracker over `frames`, labelled on the host;
    returns the tracker and its seconds."""
    from trex_tpu_torch.ops.device_tracker import _detect_kwargs
    from trex_tpu_torch.ops.labeling import label_blobs_raw
    from trex_tpu_torch.track.engine import FastTracker

    kw = _detect_kwargs(settings, {})
    det = dict(threshold=kw["detect_threshold"],
               absolute=kw["detect_absolute"],
               track_threshold=kw["track_threshold"],
               track_absolute=kw["track_absolute"])
    host = FastTracker(settings, bg)
    t0 = time.perf_counter()
    for f in range(len(frames)):
        host.add_frame(f, f / 25.0, **label_blobs_raw(frames[f], bg, **det))
    return host, time.perf_counter() - t0


def departures(host, tracker, n_frames):
    """Frames where the device history breaks ``tests/test_device_engine.py
    ::_compare_history``'s rule: a host assignment missing from it, or
    its x or y off by 1e-4 or more."""
    out = []
    for f in range(n_frames):
        hh = host.history.get(f)
        if hh is None:
            continue
        hd = tracker.history.get(f, {"fish": [], "x": [], "y": []})
        dmap = {int(i): (x, y) for i, x, y in zip(hd["fish"], hd["x"],
                                                   hd["y"])}
        for i, x, y in zip(hh["fish"], hh["x"], hh["y"]):
            d = dmap.get(int(i))
            if d is None or abs(d[0] - x) >= 1e-4 or abs(d[1] - y) >= 1e-4:
                out.append(f)
                break
    return out


def phase_device_tracker(dev, report, bg, frames, hist):
    """DeviceTracker.track_frames on the chunk of phase 4, `hist` being
    track_video_device's result on it."""
    from trex_tpu_torch.track.device_engine import DeviceTracker

    settings = track_settings()
    T = frames.shape[0]
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        tr = DeviceTracker(settings, bg, chunk=T, caps=TRACK_CAPS,
                           device=dev).track_frames(frames)
        runs.append((time.perf_counter() - t0, tr))
    (first_s, first), (wall_s, tr) = runs
    check(sorted(tr.history) == list(range(T)),
          "DeviceTracker left frames without a history entry")
    for f in range(T):
        for k in ("fish", "x", "y", "prob"):
            check(np.array_equal(first.history[f][k], tr.history[f][k]),
                  f"DeviceTracker frame {f} {k} differs between two runs")
    check(tr.assist_frames == first.assist_frames, "assists differ")

    flags = (hist["needs_host"] | hist["detect_overflow"]).cpu().numpy()
    first_flag = int(np.argmax(flags)) if flags.any() else T
    seen = hist["fish_seen"].cpu().numpy()
    fx = hist["fish_x"].cpu().numpy().astype(np.float64)
    fy = hist["fish_y"].cpu().numpy().astype(np.float64)
    for f in range(first_flag):
        fid = np.flatnonzero(seen[f])
        h = tr.history[f]
        check(np.array_equal(h["fish"], fid)
              and np.array_equal(h["x"], fx[f, fid])
              and np.array_equal(h["y"], fy[f, fid]),
              f"DeviceTracker frame {f} != track_video_device")
    check(tr.assist_frames[:1] == ([first_flag] if first_flag < T else []),
          "the first assist is not the first flagged frame")

    # the host engine over the same frames: at this density the JAX
    # package's DeviceTracker departs from its FastTracker too (ROADMAP
    # C1), so the departures are reported here and held to none below,
    # on scenes where the reference holds the rule
    host, host_s = host_track(frames, bg, settings)
    differ = departures(host, tr, T)

    # held to the host engine, on the card: a sparse full-size chunk
    # (no assist), and the two-fish scenes whose frames the scan flags
    # (replays; the storm demotes) with the JAX twin's assist counts
    sbg, sframes = synth_frames(T, n_fish=64, seed=0)
    held = {"sparse_64x1024_64": (sbg, sframes, track_settings(64), T,
                                  TRACK_CAPS, None)}
    pair = dict(track_settings(2), track_size_filter=[[10, 90]])
    for kind, want in (("merge_heavy", (21, False)),
                       ("assist_storm", (32, True))):
        held[kind] = (*pair_frames(kind), pair, 16, None, want)
    agree = {}
    for name, (hbg, hframes, hs, chunk, caps, want) in held.items():
        n = len(hframes)
        d = DeviceTracker(hs, hbg, chunk=chunk, caps=caps,
                          device=dev).track_frames(hframes)
        h, _ = host_track(hframes, hbg, hs)
        bad = departures(h, d, n)
        check(not bad, f"DeviceTracker departs from the host FastTracker "
              f"on {name} at frames {bad[:5]}")
        check(sorted(d.history) == list(range(n)) and d.n_fish == h.n_fish,
              f"{name}: history frames or n_fish differ from the host")
        if want is not None:
            check((len(d.assist_frames), d.demoted) == want,
                  f"{name}: {len(d.assist_frames)} assists, demoted "
                  f"{d.demoted}; the JAX twin gives {want}")
        agree[name] = dict(frames=n, n_fish=d.n_fish,
                           assists=len(d.assist_frames), demoted=d.demoted)

    # a small chunk: the card against the port's CPU path (which the
    # tests hold to the JAX package's DeviceTracker)
    sbg, sframes = synth_frames(24, n_fish=40, size=160, seed=0)
    small = track_settings(40)
    caps = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
                max_child_runs=1024, max_children=64)
    g = DeviceTracker(small, sbg, chunk=8, caps=caps,
                      device=dev).track_frames(sframes)
    c = DeviceTracker(small, sbg, chunk=8, caps=caps,
                      device="cpu").track_frames(sframes)
    check(g.assist_frames == c.assist_frames and g.n_fish == c.n_fish,
          "small chunk DeviceTracker: card != CPU")
    check(len(c.assist_frames) > 0, "the small chunk replayed no frame")
    for f in range(len(sframes)):
        for k in ("fish", "x", "y"):
            check(np.array_equal(g.history[f][k], c.history[f][k]),
                  f"small chunk DeviceTracker frame {f} {k}: card != CPU")
    replay_s = sum(tr.statistics[f].adding_seconds for f in tr.assist_frames)
    report["device_tracker"] = dict(
        frames=T, size=SIZE, fish=N_FISH, n_fish=tr.n_fish,
        first_call_s=first_s, s=wall_s, fps=T / wall_s,
        assist_frames=tr.assist_frames, replay_s=replay_s,
        scan_s=tr.scan_seconds, demoted=tr.demoted,
        host_fast_tracker_s=host_s, host_fps=T / host_s,
        host_n_fish=host.n_fish, frames_differing_from_host=differ,
        equal_to_host=agree, small_chunk_assists=g.assist_frames)
    print(f"phase 5 ok: DeviceTracker {T / wall_s:.1f} frames/s, "
          f"{len(tr.assist_frames)} assists ({replay_s:.3f} s replay, "
          f"{tr.scan_seconds:.3f} s scans), demoted {tr.demoted}; host "
          f"FastTracker {T / host_s:.1f} frames/s, {len(differ)} frames "
          f"depart from it (first {differ[:1]}); equal to the host engine "
          f"on {', '.join(agree)}", flush=True)


def phase_auto_split(dev, report, bg, frames, dt_frames=32):
    """The product-default configuration on the chunk of phase 4, and the
    first `dt_frames` frames of it through DeviceTracker (32: over all 64
    frames the assists relaunch the scan over 630 frames, 29 s on one
    H100)."""
    import torch

    from trex_tpu_torch.ops.device_tracker import (
        AUCTION_RANGE, SPLIT_RANGE, _detect_kwargs, default_split_spec,
        frame_times, fused_scan_packed, make_aux, params_from_settings,
        track_video_device, unpack_result)
    from trex_tpu_torch.track.device_engine import DeviceTracker

    settings = auto_settings()
    spec = default_split_spec(settings)
    T = frames.shape[0]
    fr = torch.as_tensor(frames, device=dev)
    bgt = torch.as_tensor(bg, device=dev)
    track_video_device(fr[:4], bgt, settings, device=dev, **TRACK_CAPS)
    sync()
    t0 = time.perf_counter()
    hist = track_video_device(fr, bgt, settings, device=dev, **TRACK_CAPS)
    sync()
    scan_s = time.perf_counter() - t0
    stats = []
    again = track_video_device(fr, bgt, settings, device=dev, stats=stats,
                               **TRACK_CAPS)
    for k in ("fish_row", "fish_seen", "needs_host", "fish_x"):
        check(torch.equal(hist[k], again[k]),
              f"auto-split track_video_device {k} differs between runs")
    check(not bool(hist["detect_overflow"].any()), "detect overflow")
    n_fish = int(hist["n_fish"])
    check(0 < n_fish <= N_FISH, f"n_fish {n_fish}")
    for k in ("fish_x", "fish_y", "fish_prob", "carry_vec"):
        check(bool(torch.isfinite(hist[k]).all()), f"non-finite {k}")
    flagged = (hist["needs_host"] | hist["detect_overflow"]).cpu().numpy()
    rounds = [int(st["rounds"]) for st in stats]
    n_split = [int(st["n_split"]) for st in stats]
    check(sum(n_split) > 0, "the 256-fish chunk split no blob")
    # launches a frame, in all and in the auction and the split, over 16
    # frames from the middle of the chunk (the profiler's own cost grows
    # with the events it records): one fused launch from frame 23's carry
    P = params_from_settings(settings)
    w0, w1 = 24, 40
    aux = make_aux(hist["carry_vec"][w0 - 1].cpu().numpy(),
                   frame_times(T, 25.0)[w0:w1], np.arange(w0, w1))
    packed, launches, by_part, _ = launches_by_range(
        lambda: fused_scan_packed(fr[w0:w1], bgt, aux, P, split_spec=spec,
                                  device=dev,
                                  **_detect_kwargs(settings, TRACK_CAPS)),
        (AUCTION_RANGE, SPLIT_RANGE))
    window, _ = unpack_result(packed, w1 - w0, P)
    check(np.array_equal(window["fish_row"],
                         hist["fish_row"][w0:w1].cpu().numpy()),
          "auto-split: the resumed window differs from the chunk")

    # the product engine on the same chunk
    dframes = frames[:dt_frames]
    t0 = time.perf_counter()
    tr = DeviceTracker(settings, bg, chunk=dt_frames, caps=TRACK_CAPS,
                       device=dev).track_frames(dframes)
    dt_s = time.perf_counter() - t0
    check(sorted(tr.history) == list(range(dt_frames)),
          "auto-split DeviceTracker left frames without a history entry")
    first_flag = int(np.argmax(flagged[:dt_frames])) \
        if flagged[:dt_frames].any() else dt_frames
    check(tr.assist_frames[:1] == ([first_flag] if first_flag < dt_frames
                                   else []),
          "auto-split: the first assist is not the first flagged frame")
    host, host_s = host_track(dframes, bg, settings)
    differ = departures(host, tr, dt_frames)
    replay_s = sum(tr.statistics[f].adding_seconds for f in tr.assist_frames)

    # held to the host engine: a sparse full-size chunk, the crossing
    # whose auction defers, the merge that splits on the card
    held = {}
    sbg, sframes = synth_frames(64, n_fish=64, seed=0)
    cases = [("sparse_64x1024_64", sbg, sframes, auto_settings(64), 64,
              TRACK_CAPS)]
    pair = auto_settings(2, track_size_filter=[[10, 90]])
    for kind in ("x_crossing", "merge"):
        cases.append((kind, *auto_pair_frames(kind),
                      pair if kind == "x_crossing" else
                      auto_settings(2, track_size_filter=[[10, 120]]),
                      16, None))
    for name, hbg, hframes, hs, chunk, caps in cases:
        n = len(hframes)
        st = []
        h = track_video_device(hframes, hbg, hs, device=dev, stats=st,
                               **(caps or {}))
        auction_flags = [i for i, x in enumerate(st)
                         if bool(x.get("auction_marginal", False))]
        d = DeviceTracker(hs, hbg, chunk=chunk, caps=caps,
                          device=dev).track_frames(hframes)
        ref, _ = host_track(hframes, hbg, hs)
        bad = departures(ref, d, n)
        check(not bad, f"auto-split DeviceTracker departs from the host "
              f"FastTracker on {name} at frames {bad[:5]}")
        check(sorted(d.history) == list(range(n)) and d.n_fish == ref.n_fish,
              f"{name}: history frames or n_fish differ from the host")
        splits = sum(int(x["n_split"]) for x in st)
        if name == "x_crossing":
            check(auction_flags == [10] and 10 in d.assist_frames,
                  f"x_crossing: auction flags {auction_flags}, assists "
                  f"{d.assist_frames}; the auction must defer frame 10 "
                  "to the replay")
        if name == "merge":
            check(splits > 0 and d.assist_frames == []
                  and not bool(h["needs_host"].any()),
                  f"merge: {splits} splits, assists {d.assist_frames}; "
                  "the merged blob must split on the card with no assist")
        held[name] = dict(frames=n, n_fish=d.n_fish,
                          assists=d.assist_frames, splits=splits,
                          auction_flags=auction_flags)

    # a small chunk: the card against the port's CPU path
    sbg, sframes = synth_frames(16, n_fish=24, size=192, seed=3)
    small = auto_settings(24)
    caps = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
                max_child_runs=1024, max_children=64)
    g = track_video_device(sframes, sbg, small, device=dev, **caps)
    c = track_video_device(sframes, sbg, small, device="cpu", **caps)
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "n_fish", "fish_x", "fish_y"):
        check(np.array_equal(g[k].cpu().numpy(), c[k].numpy()),
              f"auto-split small chunk {k}: card != CPU")

    report["auto_split"] = dict(
        frames=T, size=SIZE, fish=N_FISH, n_fish=n_fish, scan_s=scan_s,
        scan_fps=T / scan_s, flagged_frames=int(flagged.sum()),
        flagged_share=float(flagged.mean()),
        auction_rounds_median=statistics.median(rounds),
        auction_rounds_max=max(rounds),
        auction_cap_hits=sum(bool(x["cap_hit"]) for x in stats),
        split_targets_median=statistics.median(n_split),
        split_targets_max=max(n_split), split_lanes=spec.max_splits,
        frames_over_split_lanes=sum(v > spec.max_splits for v in n_split),
        launch_window=[w0, w1],
        launches_per_frame=None if launches is None
        else launches / (w1 - w0),
        auction_launches_per_frame=None if launches is None
        else by_part[AUCTION_RANGE] / (w1 - w0),
        split_launches_per_frame=None if launches is None
        else by_part[SPLIT_RANGE] / (w1 - w0),
        device_tracker=dict(
            frames=dt_frames, s=dt_s, fps=dt_frames / dt_s,
            assist_frames=tr.assist_frames,
            frames_scanned=tr.frames_scanned, scan_s=tr.scan_seconds,
            replay_s=replay_s, demoted=tr.demoted, n_fish=tr.n_fish,
            host_fast_tracker_s=host_s, host_fps=dt_frames / host_s,
            frames_differing_from_host=differ),
        equal_to_host=held)
    r = report["auto_split"]
    print(f"phase 6 ok: auto-split scan {r['scan_fps']:.1f} frames/s, "
          f"{r['flagged_frames']}/{T} flagged, auction rounds median "
          f"{r['auction_rounds_median']} max {r['auction_rounds_max']} "
          f"({r['auction_cap_hits']} at the cap), split targets median "
          f"{r['split_targets_median']} max {r['split_targets_max']} "
          f"({r['frames_over_split_lanes']} frames over "
          f"{spec.max_splits} lanes), {r['launches_per_frame']} launches "
          f"a frame ({r['auction_launches_per_frame']} auction, "
          f"{r['split_launches_per_frame']} split); DeviceTracker "
          f"{dt_frames / dt_s:.1f} frames/s, "
          f"{len(tr.assist_frames)} assists, {tr.frames_scanned} frames "
          f"scanned, replay {replay_s:.3f} s, {len(differ)} frames depart "
          f"from the host FastTracker; equal to the host engine on "
          f"{', '.join(held)}", flush=True)


def posture_settings(base):
    """``bench.py``'s posture variant over `base` settings:
    calculate_posture with track_posture_threshold 15 and outline
    resample 0.5 (``bench_tracking_device_variant(posture=True)``)."""
    return dict(base, calculate_posture=True, track_posture_threshold=15,
                outline_resample=0.5)


def asym_scene(n=4, n_frames=30, seed=3):
    """``tests/test_device_posture.py``'s ``_asym_frames`` scene (moving
    fish with a thick head, so the direction fix has something to orient)
    with its ``_posture_settings``: (background, frames, settings)."""
    rng = np.random.default_rng(seed)
    bg = np.full((256, 256), 200, np.uint8)
    pos = np.array([[40.0 + 50 * i, 60.0 + 40 * i] for i in range(n)])
    vel = rng.normal(0, 2.0, (n, 2))
    frames = []
    for _ in range(n_frames):
        img = bg.copy()
        for x, y in pos:
            xi, yi = int(x), int(y)
            img[yi:yi + 6, xi:xi + 14] = 90
            img[yi + 1:yi + 5, xi:xi + 8] = 70
        frames.append(img)
        pos = np.clip(pos + vel, 10, 230)
    settings = dict(track_max_individuals=n, track_max_speed=300,
                    cm_per_pixel=1.0, frame_rate=25, track_threshold=20,
                    track_threshold_is_absolute=False,
                    track_background_subtraction=True,
                    track_size_filter=[[10, 200]], calculate_posture=True,
                    track_posture_threshold=15, outline_resample=0.5,
                    match_mode="automatic")
    return bg, np.stack(frames), settings


def posture_departures(host, tracker, n_frames, tol_len=0.05,
                       tol_ang=1e-3):
    """Frames where `tracker`'s posture history breaks
    ``tests/test_device_posture.py::_compare_posture``'s rule against
    `host`'s: a fish missing, another ``ok``, or with ``ok`` a length
    off by `tol_len` px or an angle by `tol_ang` rad or more."""
    out = []
    for f in range(n_frames):
        hh = host.posture_history.get(f)
        if hh is None:
            continue
        hd = tracker.posture_history.get(f, {"fish": [], "ok": [],
                                             "midline_length": [],
                                             "angle": []})
        dm = {int(i): (bool(o), float(ln), float(a)) for i, o, ln, a in
              zip(hd["fish"], hd["ok"], hd["midline_length"], hd["angle"])}
        for i, o, ln, a in zip(hh["fish"], hh["ok"], hh["midline_length"],
                               hh["angle"]):
            d = dm.get(int(i))
            da = abs(d[2] - a) if d is not None else 0.0
            if d is None or d[0] != bool(o) or (o and (
                    abs(d[1] - ln) >= tol_len
                    or min(da, 2 * np.pi - da) >= tol_ang)):
                out.append(f)
                break
    return out


def posture_aux(P, T):
    """The aux vector of a chunk of `T` frames from frame 0 with a fresh
    carry, its posture section included when `P` has posture on."""
    from trex_tpu_torch.ops.device_tracker import (
        _carry_to_vec, _init_carry, carry_to_vec, frame_times, make_aux)

    init = _init_carry(P, 0, 0.0, device="cpu")
    vec = carry_to_vec(dict(init, posture_dir=np.zeros((P.max_fish, 2)))) \
        if P.do_posture else _carry_to_vec(init).numpy()
    return make_aux(vec, frame_times(T, 25.0), np.arange(T))


def posture_chunk(dev, settings, fr, bgt):
    """``fused_scan_packed`` over the chunk with the posture pass and
    without it (``calculate_posture`` off), warm; then the posture pass
    alone under torch.profiler, over the same chunk's detections and
    assignments (profiling the scan too would cost the profiler tens of
    seconds). Returns the report and the unpacked history with
    posture."""
    import torch

    from trex_tpu_torch.ops.device_posture import spec_from_settings
    from trex_tpu_torch.ops.device_tracker import (
        POSTURE_RANGE, _aux_split, _detect_kwargs, _posture_scan, _scan_impl,
        default_split_spec, detections_from_runcc, fused_scan_packed,
        params_from_settings, unpack_result)
    from trex_tpu_torch.ops.runcc import detect_batch_runs

    T = fr.shape[0]
    P = params_from_settings(settings)
    P0 = params_from_settings(dict(settings, calculate_posture=False))
    spec = spec_from_settings(settings, crop_h=96, crop_w=96)
    split = default_split_spec(settings, P)
    kw = _detect_kwargs(settings, TRACK_CAPS)
    aux0 = posture_aux(P0, T)
    aux = posture_aux(P, T)

    def run(p, a, **extra):
        return fused_scan_packed(fr, bgt, a, p, split_spec=split,
                                 device=dev, **extra, **kw)

    fused_scan_packed(fr[:4], bgt, aux, P, split_spec=split,
                      posture_spec=spec, device=dev, **kw)  # warm-up
    sync()
    t0 = time.perf_counter()
    plain = run(P0, aux0).cpu().numpy()
    scan_s = time.perf_counter() - t0
    sync()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    packed = run(P, aux, posture_spec=spec, posture_stats=stats)
    packed = packed.cpu().numpy()
    posture_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    det = detections_from_runcc(detect_batch_runs(fr, bgt, device=dev, **kw),
                                P)
    carry0, pdir0, times, fidx = _aux_split(
        torch.as_tensor(aux, device=dev), T, P)
    hist, _ = _scan_impl(det, times, fidx, P, carry0, fr, bgt, split)
    sync()
    t0 = time.perf_counter()
    again, launches, by_part, part_ms = launches_by_range(
        lambda: _posture_scan(fr, bgt, det, dict(hist), pdir0, P, spec),
        (POSTURE_RANGE,))
    profile_s = time.perf_counter() - t0
    h, _ = unpack_result(packed, T, P)
    check(np.array_equal(again["p_ok"].cpu().numpy(), h["p_ok"]),
          "posture: the profiled pass differs from the timed one")
    h0, _ = unpack_result(plain, T, P0)
    for k in ("fish_row", "fish_seen", "fish_child", "n_assigned",
              "fish_x", "fish_y"):
        check(np.array_equal(h[k], h0[k]),
              f"posture: the posture pass changed the scan's {k}")
    check(not (h0["needs_host"] & ~h["needs_host"]).any(),
          "posture: a frame the scan flags lost its flag")
    for k in ("p_len", "p_ang"):
        check(bool(np.isfinite(h[k]).all()), f"posture: non-finite {k}")
    check(h["p_ok"].any() and (h["p_len"][h["p_ok"]] > 1).all(),
          "posture: no midline, or one of length <= 1 px")
    assigned = h["fish_row"] >= 0
    causes = {k: int(stats[k].sum()) for k in ("child", "too_big",
                                                 "overflow")}
    flagged = h["needs_host"] & ~h0["needs_host"]
    return dict(
        frames=T, scan_s=scan_s, scan_fps=T / scan_s, posture_s=posture_s,
        posture_fps=T / posture_s,
        posture_pass_ms_per_frame=(posture_s - scan_s) / T * 1e3,
        profile_s=profile_s,
        assigned_lanes=int(assigned.sum()),
        active_lanes=stats["active_lanes"], ok_lanes=stats["ok_lanes"],
        ok_share=stats["ok_lanes"] / max(1, stats["active_lanes"]),
        flagged_frames=int(h["needs_host"].sum()),
        flagged_by_scan=int(h0["needs_host"].sum()),
        flagged_by_posture_only=int(flagged.sum()),
        frames_by_cause=causes,
        escalation_rounds_max=len(stats["round_lanes"]),
        round_lanes=stats["round_lanes"],
        trace_points_max=stats["trace_points_max"],
        walk_segments_max=stats["walk_segments_max"],
        posture_launches_per_frame=None if launches is None
        else by_part[POSTURE_RANGE] / T,
        posture_device_ms_per_frame=None if launches is None
        else part_ms[POSTURE_RANGE] / T,
        peak_mem_mb=peak / 2 ** 20), h


def phase_posture(dev, report, bg, frames, dt_frames=(64, 16)):
    """Posture on the card over the chunk of phase 4, in the base
    configuration and the product default; DeviceTracker over the first
    `dt_frames` frames of each (the product default's assists relaunch
    the scan and its posture pass over the rest of the chunk)."""
    import tempfile

    import torch

    from trex_tpu_torch.ops.device_posture import spec_from_settings
    from trex_tpu_torch.ops.device_tracker import (
        _detect_kwargs, fused_scan_packed, params_from_settings,
        unpack_result)
    from trex_tpu_torch.ops.labeling import label_blobs
    from trex_tpu_torch.track.blob import TrackBlob
    from trex_tpu_torch.track.device_engine import (DeviceTracker,
                                                    export_positions,
                                                    positions_of)

    fr = torch.as_tensor(frames, device=dev)
    bgt = torch.as_tensor(bg, device=dev)
    out = {}
    clock = {}
    t_phase = time.perf_counter()
    for (name, base), n_dt in zip((("base", track_settings()),
                                   ("auto", auto_settings())), dt_frames):
        settings = posture_settings(base)
        r, _ = posture_chunk(dev, settings, fr, bgt)
        t0 = time.perf_counter()
        tr = DeviceTracker(settings, bg, chunk=n_dt, caps=TRACK_CAPS,
                           device=dev).track_frames(frames[:n_dt])
        dt_s = time.perf_counter() - t0
        check(sorted(tr.history) == list(range(n_dt))
              and sorted(tr.posture_history) == list(range(n_dt)),
              f"posture {name}: DeviceTracker left frames without history")
        r["device_tracker"] = dict(
            frames=n_dt, s=dt_s, fps=n_dt / dt_s,
            assist_frames=tr.assist_frames,
            frames_scanned=tr.frames_scanned, scan_s=tr.scan_seconds,
            replay_s=sum(tr.statistics[f].adding_seconds
                         for f in tr.assist_frames),
            postures=sum(int(np.sum(h["ok"]))
                         for h in tr.posture_history.values()))
        out[name] = r
        clock[name] = time.perf_counter() - t_phase

    # held to the host engine, on the card: the asymmetric scene on the
    # fused path (posture on the card, no assist) and on the blob path
    # (the host's native chain per committed span)
    abg, aframes, asettings = asym_scene()
    n = len(aframes)
    host, _ = host_track(aframes, abg, asettings)
    fused = DeviceTracker(asettings, abg, chunk=8,
                          device=dev).track_frames(aframes)
    check(not fused.assist_frames, f"posture: the asymmetric scene "
          f"replayed frames {fused.assist_frames}")
    blobs = DeviceTracker(asettings, abg, chunk=16, device=dev)
    kw = _detect_kwargs(asettings, {})
    for f in range(n):
        blobs.add_frame_blobs(f, f / 25.0, [
            TrackBlob(b.lines, b.pixels, stats=b.stats)
            for b in label_blobs(aframes[f], abg, threshold=kw[
                "detect_threshold"], absolute=kw["detect_absolute"],
                track_threshold=kw["track_threshold"],
                track_absolute=kw["track_absolute"])])
    blobs.finalize()
    for label, d in (("fused", fused), ("blob", blobs)):
        bad = posture_departures(host, d, n)
        check(not bad and departures(host, d, n) == []
              and len(d.posture_history) == len(host.posture_history),
              f"posture: the {label} path departs from the host "
              f"FastTracker at frames {bad[:5]}")
    clock["held"] = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        export_positions(fused, Path(tmp) / "pos.npz")
        pos = dict(np.load(Path(tmp) / "pos.npz"))
    check(set(pos) >= set(positions_of(fused)) and pos["posture_ok"].any()
          and (pos["midline_length"][pos["posture_ok"]] > 1).all(),
          "posture: export_positions has no posture, or a length <= 1")

    # a small chunk: the card against the port's CPU path
    sbg, sframes = synth_frames(16, n_fish=24, size=192, seed=3)
    small = posture_settings(auto_settings(24))
    caps = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
                max_child_runs=1024, max_children=64)
    P = params_from_settings(small)
    spec = spec_from_settings(small, crop_h=96, crop_w=96)
    aux = posture_aux(P, 16)
    res = {}
    for d in (dev, "cpu"):
        res[str(d)] = unpack_result(fused_scan_packed(
            sframes, sbg, aux, P, posture_spec=spec, device=d,
            **_detect_kwargs(small, caps)), 16, P)[0]
    g, c = res[str(dev)], res["cpu"]
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "fish_x", "fish_y", "p_ok"):
        check(np.array_equal(g[k], c[k]), f"posture small chunk {k}: "
              "card != CPU")
    ok = c["p_ok"]
    len_err = float(np.abs(g["p_len"] - c["p_len"])[ok].max(initial=0.0))
    da = np.abs(g["p_ang"] - c["p_ang"])[ok]
    ang_err = float(np.minimum(da, 2 * np.pi - da).max(initial=0.0))
    check(ok.any() and len_err < 0.05 and ang_err < 1e-3,
          f"posture small chunk: {int(ok.sum())} postures, length error "
          f"{len_err}, angle error {ang_err}")
    out.update(
        equal_to_host=dict(frames=n, assists_fused=fused.assist_frames,
                           assists_blob=blobs.assist_frames,
                           postures=sum(int(np.sum(h["ok"])) for h in
                                        fused.posture_history.values())),
        small_chunk=dict(postures=int(ok.sum()), max_len_err=len_err,
                         max_ang_err=ang_err),
        clock_s=dict(clock, small=time.perf_counter() - t_phase))
    report["posture"] = out
    for name in ("base", "auto"):
        r = out[name]
        dt = r["device_tracker"]
        print(f"phase 7 {name}: scan {r['scan_fps']:.1f} frames/s, with "
              f"posture {r['posture_fps']:.1f}; {r['active_lanes']} active "
              f"lanes, {r['ok_share']:.3f} with a posture; flagged "
              f"{r['flagged_frames']}/{r['frames']} ({r['flagged_by_scan']} "
              f"by the scan; by cause {r['frames_by_cause']}); rounds "
              f"{r['escalation_rounds_max']}, trace points max "
              f"{r['trace_points_max']}; {r['posture_launches_per_frame']} "
              f"launches and {r['posture_device_ms_per_frame']} device ms a "
              f"frame in trex.posture; peak {r['peak_mem_mb']:.0f} MiB; "
              f"DeviceTracker {dt['fps']:.1f} frames/s over {dt['frames']}, "
              f"{len(dt['assist_frames'])} assists, {dt['frames_scanned']} "
              f"frames scanned, replay {dt['replay_s']:.3f} s, "
              f"{dt['postures']} postures", flush=True)
    print(f"phase 7 ok: equal to the host engine on the asymmetric scene "
          f"(fused and blob paths); small chunk card == CPU, length error "
          f"{len_err:.2e}, angle error {ang_err:.2e}", flush=True)


def decay_settings(base, decay=0.7):
    """`base` with ``track_speed_decay`` (0.7 is the golden fixture's,
    ``videos/test.settings`` of the reference)."""
    return dict(base, track_speed_decay=decay)


def phase_decay(dev, report, bg, frames, dt_frames=(32, 32)):
    """Speed decay on the card: the chunk of phase 4 with
    ``track_speed_decay`` 0.7 in the base configuration and the product
    default. ``track_video_device`` over the 64 frames (frames/s, flagged
    frames and how many a broken motion window flagged, launches a frame
    against the same window without decay); DeviceTracker over the first
    `dt_frames` frames of each. Held: the card to the port's CPU path on
    a small chunk that replays frames (integer outputs, flags, and the
    carry's motion window and accumulated walk bit for bit), and the
    DeviceTracker to the port's FastTracker on the sparse 64-fish chunk
    (``_compare_history``'s rule)."""
    import torch

    from trex_tpu_torch.ops.device_tracker import (
        DECAY_WIN, _detect_kwargs, _track_vec_size, default_split_spec,
        frame_times, fused_scan_packed, make_aux, params_from_settings,
        track_video_device)
    from trex_tpu_torch.track.device_engine import DeviceTracker

    fr = torch.as_tensor(frames, device=dev)
    bgt = torch.as_tensor(bg, device=dev)
    T = frames.shape[0]
    out = {}
    for (name, base), n_dt in zip((("base", track_settings()),
                                   ("auto", auto_settings())), dt_frames):
        settings = decay_settings(base)
        P = params_from_settings(settings)
        check(P.do_decay, "decay: the settings do not decay")
        track_video_device(fr[:4], bgt, settings, device=dev, **TRACK_CAPS)
        sync()
        stats = []
        t0 = time.perf_counter()
        hist = track_video_device(fr, bgt, settings, device=dev,
                                  stats=stats, **TRACK_CAPS)
        sync()
        scan_s = time.perf_counter() - t0
        check(not bool(hist["detect_overflow"].any()), "detect overflow")
        n_fish = int(hist["n_fish"])
        check(0 < n_fish <= N_FISH, f"decay {name}: n_fish {n_fish}")
        for k in ("fish_x", "fish_y", "fish_prob", "carry_vec"):
            check(bool(torch.isfinite(hist[k]).all()),
                  f"decay {name}: non-finite {k}")
        flagged = (hist["needs_host"] | hist["detect_overflow"]) \
            .cpu().numpy()
        by_decay = [bool(st["decay_flag"]) for st in stats]
        # launches a frame over 8 frames from the middle of the chunk, with
        # and without decay, each resumed from frame 23's carry
        w0, w1 = 24, 32
        launches = {}
        for label, st in (("decay", settings),
                          ("no_decay", dict(base))):
            Pw = params_from_settings(st)
            h = hist if label == "decay" else track_video_device(
                fr[:w0], bgt, st, device=dev, **TRACK_CAPS)
            aux = make_aux(h["carry_vec"][w0 - 1].cpu().numpy(),
                           frame_times(T, 25.0)[w0:w1], np.arange(w0, w1))
            _, n, _, _ = launches_by_range(
                lambda: fused_scan_packed(
                    fr[w0:w1], bgt, aux, Pw,
                    split_spec=default_split_spec(st, Pw), device=dev,
                    **_detect_kwargs(st, TRACK_CAPS)), ())
            launches[label] = None if n is None else n / (w1 - w0)
        t0 = time.perf_counter()
        tr = DeviceTracker(settings, bg, chunk=n_dt, caps=TRACK_CAPS,
                           device=dev).track_frames(frames[:n_dt])
        dt_s = time.perf_counter() - t0
        check(sorted(tr.history) == list(range(n_dt)),
              f"decay {name}: DeviceTracker left frames without history")
        first_flag = int(np.argmax(flagged[:n_dt])) \
            if flagged[:n_dt].any() else n_dt
        check(tr.assist_frames[:1] == ([first_flag] if first_flag < n_dt
                                       else []),
              f"decay {name}: the first assist is not the first flagged "
              "frame")
        out[name] = dict(
            frames=T, n_fish=n_fish, scan_s=scan_s, scan_fps=T / scan_s,
            flagged_frames=int(flagged.sum()),
            flagged_by_decay_window=int(sum(by_decay)),
            flagged_share=float(flagged.mean()),
            launch_window=[w0, w1],
            launches_per_frame=launches["decay"],
            launches_per_frame_no_decay=launches["no_decay"],
            device_tracker=dict(
                frames=n_dt, s=dt_s, fps=n_dt / dt_s,
                assist_frames=tr.assist_frames,
                frames_scanned=tr.frames_scanned, scan_s=tr.scan_seconds,
                replay_s=sum(tr.statistics[f].adding_seconds
                             for f in tr.assist_frames),
                demoted=tr.demoted, n_fish=tr.n_fish))
        r = out[name]
        dt = r["device_tracker"]
        print(f"phase 8 {name}: decay scan {r['scan_fps']:.1f} frames/s, "
              f"{r['flagged_frames']}/{T} flagged "
              f"({r['flagged_by_decay_window']} by a broken window), "
              f"{r['launches_per_frame']} launches a frame "
              f"({r['launches_per_frame_no_decay']} without decay); "
              f"DeviceTracker {dt['fps']:.1f} frames/s over {n_dt}, "
              f"{len(dt['assist_frames'])} assists, "
              f"{dt['frames_scanned']} frames scanned, replay "
              f"{dt['replay_s']:.3f} s", flush=True)

    # a small chunk that replays frames: the card against the CPU path
    sbg, sframes = synth_frames(24, n_fish=40, size=160, seed=0)
    caps = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
                max_child_runs=1024, max_children=64)
    small = {}
    for name, base in (("base", track_settings(40)),
                       ("auto", auto_settings(40))):
        st = decay_settings(base)
        P = params_from_settings(st)
        g = track_video_device(sframes, sbg, st, device=dev, **caps)
        c = track_video_device(sframes, sbg, st, device="cpu", **caps)
        for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
                  "n_assigned", "n_fish", "fish_x", "fish_y"):
            check(np.array_equal(g[k].cpu().numpy(), c[k].numpy()),
                  f"decay small chunk {name} {k}: card != CPU")
        w = _track_vec_size(P) - (5 * DECAY_WIN + 3) * P.max_fish
        gw = g["carry_vec"][:, w:].cpu().numpy()
        cw = c["carry_vec"][:, w:].numpy()
        diff = np.argwhere(gw != cw)[:3]
        vals = [(float(gw[tuple(d)]), float(cw[tuple(d)])) for d in diff]
        check(not len(diff), f"decay small chunk {name}: the carry's "
              f"window or walk, card != CPU, first (frame, offset) "
              f"{diff.tolist()}: {vals} (the walk starts at offset "
              f"{5 * DECAY_WIN * P.max_fish})")
        gd = DeviceTracker(st, sbg, chunk=8, caps=caps,
                           device=dev).track_frames(sframes)
        cd = DeviceTracker(st, sbg, chunk=8, caps=caps,
                           device="cpu").track_frames(sframes)
        check(gd.assist_frames == cd.assist_frames and gd.n_fish
              == cd.n_fish, f"decay small chunk {name} DeviceTracker: "
              "card != CPU")
        for f in range(len(sframes)):
            for k in ("fish", "x", "y"):
                check(np.array_equal(gd.history[f][k], cd.history[f][k]),
                      f"decay small chunk {name} DeviceTracker frame {f} "
                      f"{k}: card != CPU")
        small[name] = dict(flagged=int(c["needs_host"].sum()),
                           assists=gd.assist_frames)
    check(any(v["assists"] for v in small.values()),
          "decay: the small chunks replayed no frame")

    # held to the host engine on the card: the sparse full-size chunk
    sbg, sframes = synth_frames(64, n_fish=64, seed=0)
    held = {}
    for name, base in (("base", track_settings(64)),
                       ("auto", auto_settings(64))):
        st = decay_settings(base)
        n = len(sframes)
        d = DeviceTracker(st, sbg, chunk=n, caps=TRACK_CAPS,
                          device=dev).track_frames(sframes)
        h, _ = host_track(sframes, sbg, st)
        bad = departures(h, d, n)
        check(not bad, f"decay {name}: DeviceTracker departs from the host "
              f"FastTracker on the sparse chunk at frames {bad[:5]}")
        check(sorted(d.history) == list(range(n)) and d.n_fish == h.n_fish,
              f"decay {name}: history frames or n_fish differ from the "
              "host")
        held[name] = dict(frames=n, n_fish=d.n_fish,
                          assists=d.assist_frames)
    out.update(small_chunk=small, equal_to_host=held)
    report["decay"] = out
    print(f"phase 8 ok: small chunks card == CPU (assists "
          f"{[v['assists'] for v in small.values()]}); equal to the host "
          f"engine on the sparse 64-fish chunk", flush=True)


def individuals_departures(ref, got) -> list:
    """Where `got`'s per-individual archive breaks ``tests/
    test_archive.py::_assert_individuals_equal``'s rule against `ref`'s
    (per individual the frames, centroids, velocities and angles, blob
    ids, pixel counts, split flags, lines, pixels and tracklets), and the
    posture records' rule (outlines, midline segments and heights,
    lengths, angles, offsets, tails, heads): one string per
    individual that departs."""
    bad = []
    ri, gi = ref.individuals, got.individuals
    if sorted(ri) != sorted(gi):
        return [f"identities {sorted(set(ri) ^ set(gi))[:5]}"]
    for fid, a in ri.items():
        b = gi[fid]
        ok = [x.frame for x in a.basic] == [x.frame for x in b.basic] \
            and a.tracklets == b.tracklets
        for x, y in zip(a.basic, b.basic) if ok else ():
            ok = (x.centroid.x == y.centroid.x
                  and x.centroid.y == y.centroid.y
                  and x.centroid.vx == y.centroid.vx
                  and x.centroid.angle == y.centroid.angle
                  and x.blob.blob_id == y.blob.blob_id
                  and x.blob.num_pixels == y.blob.num_pixels
                  and x.blob.split == y.blob.split
                  and np.array_equal(x.blob.lines, y.blob.lines)
                  and (x.blob.pixels is None
                       or np.array_equal(x.blob.pixels, y.blob.pixels)))
            if not ok:
                break
        ok = ok and [p.frame for p in a.posture] \
            == [p.frame for p in b.posture]
        for x, y in zip(a.posture, b.posture) if ok else ():
            ok = (x.midline is None) == (y.midline is None) \
                and (x.outline is None) == (y.outline is None) \
                and (x.outline is None
                     or np.array_equal(x.outline, y.outline))
            if ok and x.midline is not None:
                m, n = x.midline, y.midline
                ok = (np.array_equal(m.segments, n.segments)
                      and np.array_equal(m.heights, n.heights)
                      and (m.len, m.angle, m.offset, m.tail_index,
                           m.head_index)
                      == (n.len, n.angle, n.offset, n.tail_index,
                          n.head_index)
                      and x.head.x == y.head.x and x.head.y == y.head.y)
            if not ok:
                break
        if not ok:
            bad.append(f"fish {fid}")
    return bad


def feed_blobs(tracker, frames, bg, settings):
    """Label each frame on the host and feed its blobs through
    ``add_frame_blobs``; returns the host seconds of the labelling."""
    from trex_tpu_torch.ops.device_tracker import _detect_kwargs
    from trex_tpu_torch.ops.labeling import label_blobs
    from trex_tpu_torch.track.blob import TrackBlob

    kw = _detect_kwargs(settings, {})
    label_s = 0.0
    for f in range(len(frames)):
        t0 = time.perf_counter()
        blobs = [TrackBlob(b.lines, b.pixels, stats=b.stats)
                 for b in label_blobs(
                     frames[f], bg, threshold=kw["detect_threshold"],
                     absolute=kw["detect_absolute"],
                     track_threshold=kw["track_threshold"],
                     track_absolute=kw["track_absolute"])]
        label_s += time.perf_counter() - t0
        tracker.add_frame_blobs(f, f / 25.0, blobs)
    return label_s


def host_archive(frames, bg, settings):
    """The port's FastTracker in archive mode over `frames`, fed the same
    blobs as ``feed_blobs``."""
    from trex_tpu_torch.track.engine import FastTracker

    host = FastTracker(settings, bg, keep_individuals=True)
    feed_blobs(host, frames, bg, settings)
    return host


def phase_archive(dev, report, bg, frames):
    """Archive mode (keep_individuals) on the card's blob path over the
    chunk of phase 4 with posture (base configuration): frames/s, the
    seconds of build_individuals, the individuals and posture records.
    Held to the port's FastTracker in archive mode on the sparse 64-fish
    chunk and on the asymmetric posture scene; on the 256-fish chunk the
    departures are reported (ROADMAP.md C1)."""
    from trex_tpu_torch.track.device_engine import DeviceTracker

    settings = posture_settings(track_settings())
    T = frames.shape[0]
    tr = DeviceTracker(settings, bg, chunk=T, keep_individuals=True,
                       device=dev)
    t0 = time.perf_counter()
    label_s = feed_blobs(tr, frames, bg, settings)
    tr.finalize()
    wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    inds = tr.individuals
    build_s = time.perf_counter() - t0
    check(sorted(tr.frame_archive) == list(range(T)),
          "archive: frames without an archive entry")
    n_rec = sum(len(v) for v in tr.posture_archive.values())
    n_post = sum(len(ind.posture) for ind in inds.values())
    check(len(inds) == tr.n_fish > 0 and n_post == n_rec > 0,
          f"archive: {len(inds)} individuals for {tr.n_fish} fish, "
          f"{n_post} postures for {n_rec} records")
    t0 = time.perf_counter()
    host = host_archive(frames, bg, settings)
    host_s = time.perf_counter() - t0
    differ = individuals_departures(host, tr)

    held = {}
    sbg, sframes = synth_frames(T, n_fish=64, seed=0)
    abg, aframes, asettings = asym_scene()
    for name, hbg, hframes, hs, chunk in (
            ("sparse_64x1024_64", sbg, sframes,
             posture_settings(track_settings(64)), T),
            ("asym", abg, aframes, asettings, 16)):
        d = DeviceTracker(hs, hbg, chunk=chunk, keep_individuals=True,
                          device=dev)
        feed_blobs(d, hframes, hbg, hs)
        d.finalize()
        h = host_archive(hframes, hbg, hs)
        bad = individuals_departures(h, d)
        check(not bad, f"archive: the DeviceTracker's individuals depart "
              f"from the host FastTracker's on {name}: {bad[:5]}")
        held[name] = dict(frames=len(hframes), individuals=len(
            d.individuals), assists=d.assist_frames, postures=sum(
            len(i.posture) for i in d.individuals.values()))
    report["archive"] = dict(
        frames=T, s=wall_s, fps=T / wall_s, label_s=label_s,
        host_s_per_frame=(wall_s - tr.scan_seconds - label_s) / T,
        scan_s=tr.scan_seconds, assist_frames=tr.assist_frames,
        build_individuals_s=build_s, individuals=len(inds),
        posture_records=n_rec, host_fast_tracker_s=host_s,
        individuals_departing_from_host=len(differ),
        equal_to_host=held)
    r = report["archive"]
    print(f"phase 9 ok: archive DeviceTracker {r['fps']:.1f} frames/s "
          f"(labelling {label_s:.2f} s, scans {tr.scan_seconds:.2f} s, "
          f"{len(tr.assist_frames)} assists), build_individuals "
          f"{build_s:.3f} s, {len(inds)} individuals, {n_rec} posture "
          f"records; {len(differ)} individuals depart from the host "
          f"FastTracker's; equal to the host engine on "
          f"{', '.join(held)}", flush=True)


PRODUCT_FRAMES = 64


def product_settings(n_fish=N_FISH):
    """The user's default tracking settings (the product default with
    posture) for a conversion of ``synth_frames``: grey storage, a
    ``max`` background (the animals are darker than the arena),
    detection and tracking on the card."""
    return dict(posture_settings(auto_settings(n_fish)),
                meta_encoding="gray", averaging_method="max",
                detect_engine="device", track_engine="device")


def array_source(frames):
    """A ``VideoSource`` of the port serving numpy frames: the card's
    machine has no OpenCV to decode files with."""
    from trex_tpu_torch.io.video import VideoSource

    class ArraySource(VideoSource):
        frame_rate = 25.0

        def __init__(self, frames):
            self.frames = frames

        def __len__(self):
            return len(self.frames)

        def get(self, index):
            return self.frames[index]

    return ArraySource(frames)


def registry(values):
    """The port's global settings, reset and set to `values`."""
    from trex_tpu_torch.config import reset_global_settings

    s = reset_global_settings()
    for k, v in values.items():
        s.set(k, v)
    return s


class Spy:
    """Wraps attributes of modules for one run: each call's seconds and
    return value are kept under the attribute's name."""

    def __init__(self, *targets):
        self.targets = targets
        self.seconds = {name: 0.0 for _, name in targets}
        self.returned = {name: [] for _, name in targets}

    def __enter__(self):
        self.saved = [(obj, name, getattr(obj, name))
                      for obj, name in self.targets]
        for obj, name, fn in self.saved:
            def wrapped(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                self.seconds[_name] += time.perf_counter() - t0
                self.returned[_name].append(out)
                return out
            setattr(obj, name, wrapped)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)


def pv_payload(path):
    """Per frame the (mask, pixel) bytes of every object of a .pv."""
    from trex_tpu_torch.io.pv import PVFile

    out = []
    with PVFile.open(path) as pv:
        for i in range(len(pv)):
            fr = pv.read_frame(i)
            out.append([(np.asarray(m).tobytes(), np.asarray(px).tobytes())
                        for m, px in zip(fr.masks, fr.pixels)])
    return out


def convert(dev, frames, path, values, track):
    """The port's Segmenter over `frames`; returns it and its wall
    seconds."""
    from trex_tpu_torch.pipeline import Segmenter
    from trex_tpu_torch.utils.timing import global_collector

    global_collector().clear()
    seg = Segmenter(registry(values), array_source(frames), path,
                    track=track, device=dev)
    t0 = time.perf_counter()
    seg.run()
    return seg, time.perf_counter() - t0


def track_cli(dev, pv, out, values, engine, extra=()):
    """``trex -i pv -d out -s settings -task track -auto_quit [extra]``
    through the port's ``cli.trex.main``; returns the wall seconds, the
    tracker and the seconds of tracking, export and .results, and the
    .results file's new name inside `out`."""
    import trex_tpu_torch.cli.trex as cli
    import trex_tpu_torch.export.results as results
    import trex_tpu_torch.pipeline as pipeline
    from trex_tpu_torch.config import write_settings_file

    out.mkdir(parents=True, exist_ok=True)
    sfile = out / "run.settings"
    write_settings_file(registry(values), sfile)
    argv = ["-i", str(pv), "-d", str(out), "-s", str(sfile), "-task",
            "track", "-track_engine", engine, "-nowindow", "-auto_quit",
            *extra]
    with Spy((pipeline.TrackingState, "run"), (cli, "_export"),
             (results, "save_results"), (results, "load_results")) as spy:
        t0 = time.perf_counter()
        rc = cli.main(argv, device=dev)
        wall = time.perf_counter() - t0
    check(rc == 0, f"product: trex {' '.join(argv)} exited {rc}")
    res = pv.with_suffix(".results")
    check(res.is_file() and any((out / "data").glob("*.npz")),
          f"product: the track task wrote no npz files or .results ({out})")
    kept = out / res.name
    res.replace(kept)
    loaded = spy.returned["load_results"]
    return dict(wall_s=wall,
                tracker=loaded[0] if loaded else spy.returned["run"][0],
                track_s=spy.seconds["run"], export_s=spy.seconds["_export"],
                results_s=spy.seconds["save_results"],
                load_s=spy.seconds["load_results"], results=kept)


def output_files(out):
    return {str(p.relative_to(out)): p.read_bytes()
            for p in sorted(out.rglob("*"))
            if p.is_file() and p.suffix in (".npz", ".csv", ".results")}


def phase_product(dev, report, n_frames=PRODUCT_FRAMES):
    """The product path at full width: the port's Segmenter converts
    ``synth_frames(n_frames)`` (256 fish at 1024^2) with detection and
    tracking on the card and writes a .pv, which is held frame for frame
    to the same conversion with the host labeler; the port's ``trex``
    CLI then tracks the .pv with ``-track_engine device -auto_quit``
    (DeviceTracker, not demoted; npz files and .results written). The
    DeviceTracker demotes to its host engine once assists pass a quarter
    of at least 64 frames, so at 64 frames it cannot have demoted: the
    CLI also tracks a video half as long again, and the frame at which the
    card handed tracking to the host is reported and held to the assist
    share of the 64-frame run. On the sparse 64-fish chunk, ``-track_engine auto`` picks the card's
    engine and writes the same npz and .results bytes as ``auto`` on the
    CPU, i.e. the host FastTracker. On the 256-fish chunk the
    individuals departing from the host FastTracker's are reported
    (ROADMAP.md C1)."""
    import shutil

    from trex_tpu_torch.track.device_engine import DeviceTracker
    from trex_tpu_torch.track.engine import FastTracker
    from trex_tpu_torch.utils.timing import global_collector

    root = REPO / "build" / "smoke_product"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    values = product_settings()
    # the first n_frames of the longer video are synth_frames(n_frames)
    bg, long_frames = synth_frames(n_frames + n_frames // 2)
    frames = long_frames[:n_frames]
    t_phase = time.perf_counter()

    seg, convert_s = convert(dev, frames, root / "p.pv", values, True)
    lanes = global_collector().summary()
    det, tr = seg.detector, seg.tracker
    check(type(tr) is DeviceTracker and not tr.demoted,
          f"product: convert tracked with {type(tr).__name__}")
    check(det.frames == n_frames and det.overflow_frames < n_frames,
          f"product: {det.overflow_frames} of {det.frames} frames "
          f"overflowed the detector's caps: the card detected nothing")
    host_seg, host_convert_s = convert(
        dev, frames, root / "host.pv", dict(values, detect_engine="host"),
        False)
    card_pv, host_pv = pv_payload(root / "p.pv"), pv_payload(root / "host.pv")
    bad = [i for i, (a, b) in enumerate(zip(card_pv, host_pv)) if a != b]
    check(len(card_pv) == len(host_pv) == n_frames and not bad,
          f"product: the .pv of detect_engine=device differs from the "
          f"host labeler's on frames {bad[:5]}")
    convert_r = dict(
        frames=n_frames, s=convert_s, fps=n_frames / convert_s,
        detect_thread_s=lanes.get("detect(device)", {}).get("total", 0.0),
        decode_s=lanes.get("decode+preprocess", {}).get("total", 0.0),
        serialize_s=lanes.get("serialize", {}).get("total", 0.0),
        scan_s=tr.scan_seconds, assists=len(tr.assist_frames),
        frames_scanned=tr.frames_scanned,
        replay_s=sum(tr.statistics[f].adding_seconds
                     for f in tr.assist_frames),
        overflow_frames=det.overflow_frames,
        detect_batch_size=det.batch_size,
        pv_bytes=(root / "p.pv").stat().st_size,
        host_labeler_convert_s=host_convert_s,
        objects=sum(len(f) for f in card_pv))

    run = track_cli(dev, root / "p.pv", root / "track", values, "device")
    tr = run["tracker"]
    check(type(tr) is DeviceTracker and not tr.demoted,
          f"product: -track_engine device tracked with "
          f"{type(tr).__name__} (demoted {getattr(tr, 'demoted', None)})")
    out_bytes = sum(len(v) for v in output_files(root / "track").values())
    track_r = dict(
        frames=n_frames, s=run["wall_s"], fps=n_frames / run["wall_s"],
        tracking_s=run["track_s"], scan_s=tr.scan_seconds,
        replay_s=sum(tr.statistics[f].adding_seconds
                     for f in tr.assist_frames),
        export_s=run["export_s"], results_s=run["results_s"],
        assists=len(tr.assist_frames), frames_scanned=tr.frames_scanned,
        individuals=len(tr.individuals), output_bytes=out_bytes,
        npz_files=len(list((root / "track" / "data").glob("*.npz"))))
    t0 = time.perf_counter()
    host = track_cli("cpu", root / "p.pv", root / "track_host", values,
                     "auto")
    check(type(host["tracker"]) is FastTracker,
          "product: auto on the CPU did not pick the FastTracker")
    differ = individuals_departures(host["tracker"], tr)
    track_r.update(host_fast_tracker_s=time.perf_counter() - t0,
                   individuals_departing_from_host=len(differ),
                   demote_rule_trips=len(tr.assist_frames)
                   > tr.demote_threshold * n_frames)

    # video length: the same scene over 1.5 * n_frames frames, detected on
    # the card without tracking, then tracked through the CLI
    n_long = len(long_frames)
    convert(dev, long_frames, root / "long.pv", values, False)
    run = track_cli(dev, root / "long.pv", root / "long", values, "device")
    lt = run["tracker"]
    check(type(lt) is DeviceTracker
          and lt.demoted == track_r["demote_rule_trips"],
          f"product: over {n_long} frames the CLI tracked with "
          f"{type(lt).__name__} (demoted {getattr(lt, 'demoted', None)}); "
          f"the 64-frame run's {track_r['assists']} assists predict "
          f"demoted {track_r['demote_rule_trips']}")
    on_card = (lt.demoted_at if lt.demoted else n_long)
    long_r = dict(
        frames=n_long, s=run["wall_s"], fps=n_long / run["wall_s"],
        tracking_s=run["track_s"], scan_s=lt.scan_seconds,
        export_s=run["export_s"], results_s=run["results_s"],
        demoted=lt.demoted, demoted_at=lt.demoted_at,
        frames_tracked_on_card=on_card,
        frames_tracked_on_host=n_long - on_card,
        assists=len(lt.assist_frames), frames_scanned=lt.frames_scanned,
        individuals=len(lt.individuals))

    sbg, sframes = synth_frames(n_frames, n_fish=64, seed=0)
    svalues = product_settings(64)
    convert(dev, sframes, root / "s.pv", svalues, False)
    card = track_cli(dev, root / "s.pv", root / "s_card", svalues, "auto")
    check(type(card["tracker"]) is DeviceTracker,
          f"product: -track_engine auto on the card picked "
          f"{type(card['tracker']).__name__}")
    hostr = track_cli("cpu", root / "s.pv", root / "s_host", svalues,
                      "auto")
    a, b = output_files(root / "s_card"), output_files(root / "s_host")
    diff = sorted(k for k in set(a) | set(b) if a.get(k) != b.get(k))
    check(len(a) > 1 and not diff,
          f"product: the sparse chunk's npz/.results of the card's engine "
          f"differ from the host FastTracker's: {diff[:5]}")
    sparse_r = dict(frames=n_frames, files=len(a), equal_bytes=sum(
        len(v) for v in a.values()), fps=n_frames / card["wall_s"],
        assists=len(card["tracker"].assist_frames),
        host_fps=n_frames / hostr["wall_s"])
    report["product"] = dict(convert=convert_r, track=track_r,
                             track_video_length=long_r,
                             sparse_64=sparse_r,
                             s=time.perf_counter() - t_phase)
    print(f"phase 10 ok: product path at {N_FISH} fish, {SIZE}^2, "
          f"{n_frames} frames: convert {convert_r['fps']:.2f} frames/s "
          f"({convert_r['overflow_frames']} of {n_frames} frames "
          f"overflowed to the host labeler, scans "
          f"{convert_r['scan_s']:.2f} s, {convert_r['assists']} assists, "
          f"{convert_r['frames_scanned']} frames scanned, replay "
          f"{convert_r['replay_s']:.2f} s; .pv equal to the host "
          f"labeler's), track {track_r['fps']:.2f} frames/s through the "
          f"CLI (tracking {track_r['tracking_s']:.2f} s, scans "
          f"{track_r['scan_s']:.2f} s, replay {track_r['replay_s']:.2f} s, "
          f"export {track_r['export_s']:.2f} s, .results "
          f"{track_r['results_s']:.2f} s, {track_r['assists']} assists, "
          f"{track_r['output_bytes']} output bytes), "
          f"{len(differ)} individuals depart from the host FastTracker's; "
          f"over {n_long} frames the CLI tracked at {long_r['fps']:.2f} "
          f"frames/s, "
          + (f"demoted to the host at frame {lt.demoted_at} "
             f"({long_r['frames_tracked_on_host']} frames on the host, "
             f"{long_r['assists']} assists before)" if lt.demoted else
             "on the card throughout")
          + "; "
          f"sparse 64-fish chunk: auto picked the DeviceTracker and its "
          f"{len(a)} npz/.results files equal the host FastTracker's",
          flush=True)


def object_settings():
    """The registry's default tracking settings with only what the
    conversion of ``synth_frames`` needs: grey storage, a ``max``
    background, detection on the card, the scene's clock and scale, and
    ``track_engine=auto``, which the DeviceTracker's checks refuse for
    the registry's ``track_threshold`` 0 and background subtraction
    off, so it picks the object Tracker."""
    return dict(meta_encoding="gray", averaging_method="max",
                detect_engine="device", track_engine="auto", frame_rate=25,
                cm_per_pixel=1.0)


def results_equal_but_engine(a, b):
    """Two .results files hold the same tracking state: their settings
    differ at most in ``track_engine``, and with equal settings they
    serialize to the same bytes."""
    from trex_tpu_torch.export import results_binary as rb

    ra, rb_ = rb.read_results(a), rb.read_results(b)

    def lines(res):
        return [ln for ln in res.settings.splitlines()
                if not ln.startswith("track_engine")]
    if lines(ra) != lines(rb_):
        return False
    rb_.settings = ra.settings
    rb.write_results(a.with_suffix(".a"), ra)
    rb.write_results(b.with_suffix(".b"), rb_)
    return a.with_suffix(".a").read_bytes() == b.with_suffix(".b").read_bytes()


# The object Tracker takes a blob's orientation from its run sums, the
# FastTracker's archive from the labeler's moment sums: the JAX package's
# engines write angles that differ in the last bits through the track task
# (ROADMAP.md C5). Those columns are held within these bounds (rad, rad/s,
# rad/s^2 at 25 frames/s), every other npz column bit for bit.
ANGLE_BOUNDS = {"ANGLE": 1e-9, "ANGULAR_V": 5e-8, "ANGULAR_A": 2.5e-6}


def npz_departures(a: dict, b: dict):
    """Files of `a` and `b` (name -> npz bytes) that differ beyond
    :data:`ANGLE_BOUNDS`, and the largest angle departure found."""
    import io

    bad, worst = [], 0.0
    for k in sorted(set(a) | set(b)):
        if a.get(k) == b.get(k):
            continue
        if k not in a or k not in b:
            bad.append(k)
            continue
        x, y = np.load(io.BytesIO(a[k])), np.load(io.BytesIO(b[k]))
        for col in sorted(set(x.files) | set(y.files)):
            u = x[col] if col in x.files else None
            v = y[col] if col in y.files else None
            if u is not None and v is not None and u.shape == v.shape \
                    and u.dtype == v.dtype and u.tobytes() == v.tobytes():
                continue
            bound = ANGLE_BOUNDS.get(col)
            if bound is None or u is None or v is None \
                    or u.shape != v.shape:
                bad.append(f"{k}:{col}")
                continue
            same = (u == v) | (np.isnan(u) & np.isnan(v))
            with np.errstate(invalid="ignore"):
                d = np.where(same, 0.0, np.abs(u - v))
            if col == "ANGLE":
                d = np.minimum(d, 2 * np.pi - d)
            if not (d <= bound).all():
                bad.append(f"{k}:{col}")
            if col == "ANGLE":
                worst = max(worst, float(np.nanmax(d)))
    return bad, worst


def npz_files(out):
    return {k: v for k, v in output_files(out).items()
            if k.endswith(".npz") and "_statistics" not in k
            and "_memory" not in k and "_heatmap" not in k}


def phase_object(dev, report, n_frames=PRODUCT_FRAMES, n_fish=N_FISH,
                 size=SIZE, sparse_fish=64):
    """The object Tracker (``object``): the registry's default tracking
    settings, which both fast engines refuse, through the entry points a
    user calls. The port's Segmenter converts ``synth_frames(n_frames)``
    with detection on the card, and ``track_engine=auto`` picks the
    object Tracker for the reason it records; the CLI's track task
    (``-track_engine auto -auto_quit`` with output_statistics,
    output_heatmaps and gui_show_memory_stats) writes the npz files, the
    statistics, the heatmaps and the .results; a second track task with
    ``-load`` restores that .results and writes the same npz bytes. On
    the sparse chunk, under ``product_settings`` (which both engines
    accept), ``-track_engine object`` and ``-track_engine fast`` write
    byte-equal per-fish npz files and .results equal but for the
    recorded ``track_engine`` (``tests/test_archive.py``'s contract)."""
    import shutil

    from trex_tpu_torch.track.tracker import Tracker
    from trex_tpu_torch.utils.timing import global_collector

    root = REPO / "build" / "smoke_object"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    values = object_settings()
    bg, frames = synth_frames(n_frames, n_fish=n_fish, size=size)
    t_phase = time.perf_counter()

    seg, convert_s = convert(dev, frames, root / "o.pv", values, True)
    lanes = global_collector().summary()
    tr = seg.tracker
    reasons = ("refuses track_threshold == 0",
               "refuses track_background_subtraction off")
    check(type(tr) is Tracker and seg.engine_choice.startswith(
        "track_engine=auto: object Tracker (host), ")
        and seg.engine_choice.endswith(reasons),
        f"object: convert picked {type(tr).__name__} "
        f"({seg.engine_choice})")
    check(seg.detector.frames == n_frames
          and seg.detector.overflow_frames < n_frames,
          f"object: {seg.detector.overflow_frames} of "
          f"{seg.detector.frames} frames overflowed the detector's caps")
    stats = [tr.statistics[f] for f in sorted(tr.statistics)]
    check(len(stats) == n_frames and 0 < len(tr.individuals) <= 2 * n_fish,
          f"object: convert tracked {len(stats)} frames, "
          f"{len(tr.individuals)} individuals")
    convert_r = dict(
        frames=n_frames, s=convert_s, fps=n_frames / convert_s,
        detect_thread_s=lanes.get("detect(device)", {}).get("total", 0.0),
        track_lane_s=lanes.get("track", {}).get("total", 0.0),
        adding_s_per_frame=sum(s.adding_seconds for s in stats) / n_frames,
        posture_s_per_frame=sum(s.posture_seconds for s in stats)
        / n_frames,
        individuals=len(tr.individuals),
        overflow_frames=seg.detector.overflow_frames,
        engine_choice=seg.engine_choice,
        pv_bytes=(root / "o.pv").stat().st_size)

    outputs = ["-output_statistics", "true", "-output_heatmaps", "true",
               "-gui_show_memory_stats", "true"]
    run = track_cli(dev, root / "o.pv", root / "track", values, "auto",
                    outputs)
    tt = run["tracker"]
    check(type(tt) is Tracker and tt.engine_choice.endswith(reasons),
          f"object: the CLI's track task picked {type(tt).__name__} "
          f"({getattr(tt, 'engine_choice', None)})")
    files = output_files(root / "track")
    data = root / "track" / "data"
    check(any(data.glob("*_statistics.npz"))
          and any(data.glob("*_heatmap_*.npz"))
          and len(npz_files(root / "track")) >= 2,
          f"object: the track task wrote {sorted(files)[:8]}")
    tstats = [tt.statistics[f] for f in sorted(tt.statistics)]
    track_r = dict(
        frames=n_frames, s=run["wall_s"], fps=n_frames / run["wall_s"],
        tracking_s=run["track_s"], export_s=run["export_s"],
        results_s=run["results_s"],
        adding_s_per_frame=sum(s.adding_seconds for s in tstats) / n_frames,
        posture_s_per_frame=sum(s.posture_seconds for s in tstats)
        / n_frames,
        loading_s_per_frame=sum(s.loading_seconds for s in tstats)
        / n_frames,
        individuals=len(tt.individuals),
        output_bytes=sum(len(v) for v in files.values()),
        npz_files=len(npz_files(root / "track")))

    # -load: the .results beside the .pv, restored into the object
    # Tracker. The .results keeps positions in float32 and no head or
    # posture-centroid motion, so the first reload holds the track task's
    # identities, frames and float32 positions, and a second -load, of the
    # .results the first one wrote, reproduces its npz and .results bytes.
    loads = []
    for n, res in enumerate((run["results"], None)):
        shutil.copy(res or loads[-1]["results"],
                    (root / "o.pv").with_suffix(".results"))
        loads.append(track_cli(dev, root / "o.pv", root / f"reload{n}",
                               values, "auto", ["-load"]))
        check(type(loads[-1]["tracker"]) is Tracker,
              f"object: -load restored {type(loads[-1]['tracker'])}")
    lt = loads[0]["tracker"]
    moved = [fid for fid, ind in tt.individuals.items()
             if fid not in lt.individuals
             or [b.frame for b in ind.basic]
             != [b.frame for b in lt.individuals[fid].basic]
             or any(np.float32(a.centroid.x) != np.float32(b.centroid.x)
                    or np.float32(a.centroid.y) != np.float32(b.centroid.y)
                    for a, b in zip(ind.basic, lt.individuals[fid].basic))]
    check(sorted(lt.individuals) == sorted(tt.individuals) and not moved,
          f"object: -load restored other identities, frames or positions "
          f"than the track task's: {moved[:5]}")
    want, got = npz_files(root / "reload0"), npz_files(root / "reload1")
    diff = sorted(k for k in set(want) | set(got)
                  if want.get(k) != got.get(k))
    check(len(want) >= 2 and not diff
          and loads[0]["results"].read_bytes()
          == loads[1]["results"].read_bytes(),
          f"object: a second -load wrote other npz files or .results than "
          f"the first: {diff[:5]}")
    reload_r = dict(s=loads[0]["wall_s"], load_s=loads[0]["load_s"],
                    export_s=loads[0]["export_s"],
                    equal_npz_files=len(want))

    # object and fast on the sparse chunk, under settings both take
    sbg, sframes = synth_frames(n_frames, n_fish=sparse_fish, size=size)
    svalues = product_settings(sparse_fish)
    convert(dev, sframes, root / "s.pv", svalues, False)
    pair = {}
    for engine in ("object", "fast"):
        pv = root / f"s_{engine}" / "s.pv"
        pv.parent.mkdir()
        shutil.copy(root / "s.pv", pv)
        pair[engine] = track_cli(dev, pv, pv.parent / "out", svalues, engine)
    a = npz_files(root / "s_object" / "out")
    b = npz_files(root / "s_fast" / "out")
    diff, worst_angle = npz_departures(a, b)
    check(len(a) > 1 and not diff,
          f"object: the sparse chunk's npz files of -track_engine object "
          f"and fast differ: {diff[:5]}")
    check(results_equal_but_engine(pair["object"]["results"],
                                   pair["fast"]["results"]),
          "object: the sparse chunk's .results of object and fast differ "
          "beyond track_engine")
    sparse_r = dict(frames=n_frames, fish=sparse_fish, npz_files=len(a),
                    byte_equal_files=sum(a[k] == b[k] for k in a),
                    npz_bytes=sum(len(v) for v in a.values()),
                    max_angle_departure=worst_angle,
                    object_fps=n_frames / pair["object"]["wall_s"],
                    fast_fps=n_frames / pair["fast"]["wall_s"])
    report["object"] = dict(convert=convert_r, track=track_r,
                            reload=reload_r, sparse=sparse_r,
                            s=time.perf_counter() - t_phase)
    print(f"phase 11 ok: object Tracker at {n_fish} fish, {size}^2, "
          f"{n_frames} frames, registry defaults "
          f"({seg.engine_choice}): convert {convert_r['fps']:.2f} frames/s "
          f"(detection thread {convert_r['detect_thread_s']:.2f} s, add "
          f"{convert_r['adding_s_per_frame'] * 1e3:.1f} ms and posture "
          f"{convert_r['posture_s_per_frame'] * 1e3:.1f} ms a frame, "
          f"{convert_r['individuals']} individuals), track "
          f"{track_r['fps']:.2f} frames/s through the CLI (add "
          f"{track_r['adding_s_per_frame'] * 1e3:.1f} ms, posture "
          f"{track_r['posture_s_per_frame'] * 1e3:.1f} ms a frame, export "
          f"{track_r['export_s']:.2f} s, {track_r['individuals']} "
          f"individuals, {track_r['output_bytes']} output bytes); -load "
          f"wrote the same {len(want)} npz files twice; sparse "
          f"{sparse_fish}-fish chunk: object and fast wrote {len(a)} npz "
          f"files, {sparse_r['byte_equal_files']} byte-equal, the rest "
          f"departing only in their angles (at most {worst_angle:.3g} rad, "
          f"ROADMAP.md C5) and .results equal but for track_engine",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the report as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "trex_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no trex_tpu_torch package in {REPO}",
              file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    report = {"torch": torch.__version__, "cuda": torch.version.cuda}
    kern = []
    t0 = time.perf_counter()
    phase_kernels(dev, report)
    phase_detect(dev, report, kern)
    phase_label(dev, report, kern)
    chunk = phase_track(dev, report)
    phase_device_tracker(dev, report, *chunk)
    phase_auto_split(dev, report, *chunk[:2])
    phase_posture(dev, report, *chunk[:2])
    phase_decay(dev, report, *chunk[:2])
    phase_archive(dev, report, *chunk[:2])
    phase_product(dev, report)
    phase_object(dev, report)
    report["total_s"] = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    report["card"] = card
    report["kernels"] = kern
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: report[k] for k in (
        "detect", "label", "track", "device_tracker", "auto_split",
        "posture", "decay", "archive", "product", "object", "build_s",
        "total_s")}))
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
