#!/usr/bin/env python3
"""Smoke run of the PyTorch port (trex_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each raising on failure:

1. Build every CUDA kernel of the port from ``trex_tpu_torch/csrc`` and
   hold each against its plain PyTorch version on random masks
   (densities 0.1 / 0.35 / 0.6, widths that are not a multiple of 128,
   S-shapes that span the frame): labels must be equal (torch.equal).
2. Pixel-grid detection at full size: ``detect_batch(use_pallas=True)``
   on 32 synthetic frames of 1024^2 with 256 fish. Equal to the same
   call through the plain labeler, and slot for slot equal to the
   run-based ``detect_batch_runs`` on every frame where neither
   overflows. The CUDA labeler's launch count must have moved.
3. Device tracking chunk at full size: ``track_video_device`` on 64
   synthetic frames of 1024^2 with 256 fish (the base configuration:
   approximate matching, no history split). No detect overflow,
   0 < n_fish <= 256, and the packed result of ``fused_scan_packed``
   on the same chunk equals the dict result. On a small chunk the card
   gives the same integer outputs as the port's CPU path (which the
   tests hold to the JAX package).
4. Report: frames per second of phases 2 and 3, the card's name and
   power limit, and one JSON line with every kernel's launches on the
   main path, error against its plain version, time, bound and the
   plain version's time. The last line is
   ``{"ok": true, "device": {...}}``.

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


def phase_kernels(dev, report):
    import torch

    from trex_tpu_torch import kernels
    from trex_tpu_torch.ops.cc_device import (label_components_plain,
                                              label_components_vmem)

    t0 = time.perf_counter()
    took = kernels.build(verbose=True)
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = took
    rng = np.random.default_rng(0)
    cases = [rng.random((4, 517, 1000)) < d for d in (0.1, 0.35, 0.6)]
    cases.append(rng.random((2, 1024, 1024)) < 0.35)
    cases.append(np.stack([s_shape_mask(1024, 1000, 64),
                           s_shape_mask(1024, 1000, 300)]))
    cases.append(s_shape_mask(333, 1021, 41)[None])
    for m in cases:
        mt = torch.as_tensor(m)
        got = label_components_vmem(mt.to(dev))
        sync()
        ref = label_components_plain(mt.to(dev))
        check(torch.equal(got, ref),
              f"ccl kernel != plain on a {tuple(m.shape)} mask")
    print(f"phase 1 ok: ccl built in {report['build_s']:.1f} s, "
          f"{len(cases)} mask sets equal to the plain labeler", flush=True)


def phase_detect(dev, report, kern):
    import torch

    from trex_tpu_torch import kernels
    from trex_tpu_torch.ops.cc_device import (label_components_plain,
                                              label_components_vmem)
    from trex_tpu_torch.ops.device_pipeline import detect_batch
    from trex_tpu_torch.ops.runcc import detect_batch_runs

    bg, frames = synth_frames(32)
    fr = torch.as_tensor(frames, device=dev)
    bgt = torch.as_tensor(bg, device=dev)
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
    f16 = fr.to(torch.int16)
    mask = ((bgt.to(torch.int16)[None] - f16) >= 15) & (fr > 0)
    got = label_components_vmem(mask)
    ref = label_components_plain(mask)
    err = int((got.long() - ref.long()).abs().max())
    check(err == 0, "ccl kernel != plain on the detection masks")
    ms = time_ms(lambda: label_components_vmem(mask), iters=20)
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
    })
    print(f"phase 2 ok: pixel-grid detection {report['detect']['fps']:.1f} "
          f"frames/s, {compared}/32 frames equal to run-based slot for slot",
          flush=True)


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
    print(f"phase 3 ok: tracking chunk {report['track']['fps']:.1f} "
          f"frames/s, n_fish {n_fish}", flush=True)


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
    phase_track(dev, report)
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
    print(json.dumps({"detect": report["detect"], "track": report["track"],
                      "build_s": report["build_s"],
                      "total_s": report["total_s"]}))
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
