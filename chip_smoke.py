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
7. Report: frames per second of phases 2-6, the replay's assist frames
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
    torch.profiler.record_function range}). The counts are None when the
    profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync()
    total = 0
    per = dict.fromkeys(ranges, 0)
    for e in prof.events():
        # a range's own span on the device timeline is no launch
        k = sum(kk.name not in per for kk in e.kernels)
        if not k:
            continue
        total += k
        p = e.cpu_parent
        while p is not None and p.name not in per:
            p = p.cpu_parent
        if p is not None:
            per[p.name] += k
    if not total:
        return out, None, dict.fromkeys(ranges)
    return out, total, per


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
    packed, launches, by_part = launches_by_range(
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
        "build_s", "total_s")}))
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
