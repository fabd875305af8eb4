#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's main path on one CUDA card.

    python3 torch_profile.py [--out profile.json] [--only NAME ...]

Profiles, with ``torch.profiler`` over a warm call each, the entry points
that ``chip_smoke.py`` drives at the same sizes: pixel-grid detection
(``detect_batch(use_pallas=True)``, 32 frames of 1024^2, 256 fish),
propagation labelling of its masks (``label_components(use_pallas=True)``),
the run-based detection alone, the tracking chunk
(``track_video_device``, 64 frames of 1024^2, 256 fish) and the product
engine over the same chunk (``DeviceTracker.track_frames``), both in the
base configuration and in the product default (``auto``: the optimal
matcher and the history split on the card; the product engine over the
chunk's first 32 frames, as ``chip_smoke.py`` phase 6 runs it).
``--only`` profiles the named targets alone. For each it
prints the host wall time, the summed device time of the kernels and the
device's idle share over the call, the kernels with the most device time,
the PyTorch operators that launched most of it, and the port's own CUDA
kernels (each pass of the labeler ``ccl_*`` and the stencil
``neighbor_min*``) with their device time and launch count. Exits
non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import chip_smoke as smoke


def profile_call(fn, top=12) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    from trex_tpu_torch.ops.device_tracker import AUCTION_RANGE, SPLIT_RANGE

    names = (AUCTION_RANGE, SPLIT_RANGE)
    rows = prof.key_averages()
    # record_function ranges also show on the device timeline as spans,
    # which are no kernels
    kern = [e for e in rows if e.device_type == DeviceType.CUDA
            and e.key not in names]
    ops = [e for e in rows if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::") and smoke.device_us(e) > 0]
    device_us = sum(smoke.device_us(e) for e in kern)
    port = [e for e in kern
            if smoke.kernel_name(e.key).startswith(smoke.PORT_KERNELS)]

    def by(es):
        return sorted(es, key=smoke.device_us, reverse=True)[:top]

    # launches and device time inside the scan's record_function ranges
    # (the auction, the history split)
    ranges = {r: {"launches": 0, "device_ms": 0.0} for r in names}
    for e in prof.events():
        ks = [k for k in e.kernels if k.name not in ranges]
        if not ks:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in ranges:
            p = p.cpu_parent
        if p is not None:
            ranges[p.name]["launches"] += len(ks)
            ranges[p.name]["device_ms"] += sum(k.duration for k in ks) / 1e3

    return {
        "ranges": ranges,
        "wall_ms": wall_us / 1e3,
        "device_ms": device_us / 1e3,
        "idle_share": (1.0 - device_us / wall_us) if device_us else None,
        "launches": sum(e.count for e in kern),
        "kernels": [{"name": e.key[:90], "ms": smoke.device_us(e) / 1e3,
                     "count": e.count} for e in by(kern)],
        "ops": [{"name": e.key, "ms": smoke.device_us(e) / 1e3,
                 "count": e.count} for e in by(ops)],
        "port_kernels": [{"name": smoke.kernel_name(e.key),
                          "ms": smoke.device_us(e) / 1e3, "count": e.count}
                         for e in by(port)],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the report as JSON here")
    ap.add_argument("--only", nargs="+", help="profile these targets only")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    from trex_tpu_torch.ops.cc_device import label_components
    from trex_tpu_torch.ops.device_pipeline import detect_batch
    from trex_tpu_torch.ops.device_tracker import (_detect_kwargs,
                                                   track_video_device)
    from trex_tpu_torch.ops.runcc import detect_batch_runs
    from trex_tpu_torch.track.device_engine import DeviceTracker

    dev = torch.device("cuda", 0)
    bg, frames = smoke.synth_frames(64)
    fr = torch.as_tensor(frames, device=dev)
    bgt = torch.as_tensor(bg, device=dev)
    settings = smoke.track_settings()
    kw = dict(threshold=15, absolute=False, track_threshold=20,
              max_blobs=256)
    mask = ((bgt.to(torch.int16)[None] - fr[:32].to(torch.int16)) >= 15) \
        & (fr[:32] > 0)
    auto = smoke.auto_settings()
    targets = {
        "detect_batch_pallas_32": lambda: detect_batch(
            fr[:32], bgt, use_pallas=True, device=dev, **kw),
        "label_components_pallas_32": lambda: label_components(
            mask, use_pallas=True),
        "detect_batch_runs_64": lambda: detect_batch_runs(
            fr, bgt, device=dev,
            **_detect_kwargs(settings, smoke.TRACK_CAPS)),
        "track_video_device_64": lambda: track_video_device(
            fr, bgt, settings, device=dev, **smoke.TRACK_CAPS),
        "device_tracker_64": lambda: DeviceTracker(
            settings, bg, chunk=64, caps=smoke.TRACK_CAPS,
            device=dev).track_frames(frames),
        "track_video_device_auto_64": lambda: track_video_device(
            fr, bgt, auto, device=dev, **smoke.TRACK_CAPS),
        "device_tracker_auto_32": lambda: DeviceTracker(
            auto, bg, chunk=32, caps=smoke.TRACK_CAPS,
            device=dev).track_frames(frames[:32]),
    }
    report = {name: profile_call(fn) for name, fn in targets.items()
              if not args.only or name in args.only}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    report["card"] = smi.stdout.strip()
    for name, r in report.items():
        if name == "card":
            continue
        share = r["idle_share"]
        print(f"{name}: wall {r['wall_ms']:.2f} ms, device "
              f"{r['device_ms']:.2f} ms, idle share "
              f"{'not measured' if share is None else f'{share:.3f}'}, "
              f"{r['launches']} kernel launches")
        for rng, v in r["ranges"].items():
            if v["launches"]:
                print(f"    {v['device_ms']:9.3f} ms  x{v['launches']:<6} "
                      f"range {rng}")
        for k in r["ops"][:8]:
            print(f"    {k['ms']:9.3f} ms  x{k['count']:<6} {k['name']}")
        for k in r["port_kernels"]:
            print(f"    {k['ms']:9.3f} ms  x{k['count']:<6} kernel "
                  f"{k['name']}")
    print(report["card"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
