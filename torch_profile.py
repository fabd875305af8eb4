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
chunk's first 32 frames, as ``chip_smoke.py`` phase 6 runs it), and
with posture (``chip_smoke.posture_settings``: ``fused_scan_packed``
with the posture pass over the 64 frames in both configurations, the
product engine over the first 32 frames in the base one), and ten
steps of the VI network's training (``vi_train_step_128``:
``VITrainer``'s train step, v118_3 at 80x80 with 15 classes in
bfloat16 on 128-batches, as ``chip_smoke.py`` phase 13 trains it), and
one frame's visual-field projection (``raycast_251``:
``ops/raycast.py::_visual_field`` on ``chip_smoke.vf_scene`` with 251
fish of 256 points and shapes of 20000 and 10000 points in a 1024^2
arena, the size of ``chip_smoke.py`` phase 14's frames), and one
frame's tag decode (``tag_decode_256``: the default tag network,
``TagDecoderNet(256, 32)`` as a keras ``KerasSequential``, on 256 rendered
tag crops through ``TagDecoder.batch``, one forward with the copies in
and out and the ids and confidences, as ``chip_smoke.py`` phase 15's
tracker decodes a frame), and one warm 8-image forward plus decode of
the YOLOv8x pose model at 640 (``yolo_x_pose_640_b8``:
``chip_smoke.write_yolo_pt``'s seeded weights through
``create_detection``, ``YOLODetector.infer_device`` on 8 letterboxed
frames of the tracking chunk, one batch of phase 16's
``detect_batch_size``), and one warm encode of a 1024^2 frame plus the
decode of 32 box prompts by a random ViT-B SAM in bfloat16
(``sam_vitb_1024``: ``chip_smoke.write_sam_pth``'s seeded weights
through ``SamSegmenter.from_checkpoint``, the boxes of
``chip_smoke.sam_prompt``, as ``chip_smoke.py`` phase 17 segments a
frame).
``--only`` profiles the named targets alone. For each it
prints the host wall time (under the profiler, and of one more warm call
without it), the summed device time of the kernels and the
device's idle share over the call, the peak device memory of the call,
the kernels with the most device time,
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

import numpy as np

import chip_smoke as smoke


def profile_call(fn, top=12) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # one more warm call without the profiler: for calls of a few
    # milliseconds the profiler's own start dominates its wall
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_us = (time.perf_counter() - t0) * 1e6
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    from trex_tpu_torch.ops.device_tracker import (AUCTION_RANGE,
                                                   POSTURE_RANGE,
                                                   SPLIT_RANGE)

    names = (AUCTION_RANGE, SPLIT_RANGE, POSTURE_RANGE)
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

    # launches and device time inside the record_function ranges (the
    # auction, the history split, the posture pass)
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
        "wall_unprofiled_ms": plain_wall_us / 1e3,
        "device_ms": device_us / 1e3,
        "idle_share": (1.0 - device_us / wall_us) if device_us else None,
        "peak_mem_gb": peak_gb,
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
    from trex_tpu_torch.ops.device_posture import (
        spec_from_settings as posture_spec)
    from trex_tpu_torch.ops.device_tracker import (_detect_kwargs,
                                                   default_split_spec,
                                                   fused_scan_packed,
                                                   params_from_settings,
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

    def posture_scan(base):
        s = smoke.posture_settings(base)
        P = params_from_settings(s)
        aux = smoke.posture_aux(P, len(frames))
        return lambda: fused_scan_packed(
            fr, bgt, aux, P, split_spec=default_split_spec(s, P),
            posture_spec=posture_spec(s, crop_h=96, crop_w=96), device=dev,
            **_detect_kwargs(s, smoke.TRACK_CAPS))

    def vi_train_steps(n=10, classes=15):
        from trex_tpu_torch.models import VITrainer, build

        t = VITrainer(build("v118_3", classes), classes, (80, 80, 1),
                      device=dev)
        x = torch.randint(0, 256, (128, 1, 80, 80), device=dev,
                          generator=torch.Generator(dev).manual_seed(0)) \
            .float()
        y = torch.arange(128, device=dev) % classes

        def run():
            for _ in range(n):
                t._train_step(t.opt, x, y, t._dropout_rng)
        return run

    def raycast(n_fish=251):
        from trex_tpu_torch.ops.raycast import _visual_field

        pts, ids, valid, eye_pos, eye_angle, max_d = smoke.vf_scene(
            0, n_fish, 256, shape_points=(20000, 10000), size=1024.0)
        t = [torch.as_tensor(a, device=dev) for a in (
            pts, ids, valid.astype(np.int32), eye_pos, eye_angle)]
        return lambda: _visual_field(*t, float(max_d))

    def tag_decode(n=256):
        from trex_tpu_torch.ml.tagwork import (KerasSequential, TagDecoder,
                                               TagDecoderNet, Tagwork,
                                               _Layer)

        specs = TagDecoderNet(256, 32, seed=0, device=dev).layer_specs()
        tw = Tagwork(32, 32, None, device=dev)
        tw.model = KerasSequential([_Layer(k, c, w) for k, c, w in specs],
                                   device=dev)
        crops, _ = smoke.tag_crops(range(n), 1)
        dec = TagDecoder(tw)
        return lambda: dec.batch(list(crops))

    def yolo_forward(batch=8):
        """One 640 batch through the YOLOv8x pose model and its decode,
        as ``chip_smoke.py`` phase 16's detector runs it; the model is
        written and loaded at the first (warm-up) call."""
        made = {}

        def run():
            if not made:
                from trex_tpu_torch.config import Settings
                from trex_tpu_torch.detect.base import create_detection

                root = smoke.REPO / "build" / "profile_yolo"
                root.mkdir(parents=True, exist_ok=True)
                path = smoke.write_yolo_pt(root, frames[:4], dev)["letterbox"]
                s = Settings()
                for k, v in smoke.yolo_settings(path).items():
                    s.set(k, v)
                det = create_detection(s, device=dev).detector
                made["det"] = det
                made["canvas"] = np.stack(
                    [det._prepare(f, det.input_size) for f in frames[:batch]])
            return made["det"].infer_device(made["canvas"])

        return run

    def sam_forward():
        """One frame's encode and the decode of phase 17's boxes by the
        bfloat16 ViT-B on the card; the model is written and loaded at
        the first (warm-up) call."""
        made = {}

        def run():
            if not made:
                from trex_tpu_torch.detect.sam3 import (Sam3Prompts,
                                                        SamSegmenter)

                root = smoke.REPO / "build" / "profile_sam"
                root.mkdir(parents=True, exist_ok=True)
                path, _ = smoke.write_sam_pth(root)
                made["model"] = SamSegmenter.from_checkpoint(
                    path, device=dev).model
                _, scene, track = smoke.synth_scene(1)
                boxes = [o.seed_box for o in Sam3Prompts.from_setting(
                    smoke.sam_prompt(track)).materialize(0)]
                made["img"] = torch.as_tensor(np.repeat(
                    scene[0][None, :, :, None], 3, 3), device=dev)
                made["pts"] = torch.tensor(boxes, dtype=torch.float32,
                                           device=dev).reshape(-1, 2, 2)
                made["lbl"] = torch.tensor([[2, 3]] * len(boxes),
                                           dtype=torch.int32, device=dev)
            m = made["model"]
            with torch.no_grad():
                emb = m.encode(made["img"])
                return m.decode(emb[0], made["pts"], made["lbl"])

        return run

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
        "fused_scan_posture_64": posture_scan(settings),
        "fused_scan_posture_auto_64": posture_scan(auto),
        "device_tracker_posture_32": lambda: DeviceTracker(
            smoke.posture_settings(settings), bg, chunk=32,
            caps=smoke.TRACK_CAPS, device=dev).track_frames(frames[:32]),
        "vi_train_step_128": vi_train_steps(),
        "raycast_251": raycast(),
        "tag_decode_256": tag_decode(),
        "yolo_x_pose_640_b8": yolo_forward(),
        "sam_vitb_1024": sam_forward(),
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
        print(f"{name}: wall {r['wall_ms']:.2f} ms "
              f"({r['wall_unprofiled_ms']:.2f} ms without the profiler), device "
              f"{r['device_ms']:.2f} ms, idle share "
              f"{'not measured' if share is None else f'{share:.3f}'}, "
              f"{r['launches']} kernel launches, peak "
              f"{r['peak_mem_gb']:.2f} GB")
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
