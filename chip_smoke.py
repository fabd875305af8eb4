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
   device time a frame inside the ``trex.posture`` range over the first
   16 frames (a depth cut of the profile), and the pass's peak memory. ``DeviceTracker.track_frames`` over 64 frames (base) and 16
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
   without decay; ``DeviceTracker.track_frames`` over 32 frames (base)
   and 16 (product default) with its assists, frames scanned and replay
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
    80 frames, where the DeviceTracker demotes to the host once past 64.
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
12. VI apply (``vi``): phase 11's .pv and .results (251 individuals over
    64 frames) with a v118_3 network at 80x80, one class per individual,
    made from a seeded ``torch.Generator``, its head the CPU twin test's
    nearest-prototype head (``tests/test_torch_vi_apply.py``, scaled by
    :data:`VI_HEAD_SCALE`), saved with the port's ``save_weights``; the
    CLI runs ``-task track -load -auto_apply -output_recognition_data
    true -output_tracklet_images true -auto_quit`` with the network on
    the card. Every stored prediction row is held to the port's CPU
    forward of the same crops within :data:`VI_PROB_TOL`, the
    corrections to the CPU rows' for every tracklet whose decisions have
    margins above twice that (:func:`vi_decided`), and the re-tracked
    .results and npz files load again. Crops/s of the host crop path,
    the network's images/s and ms per 512-batch on the card, seconds of
    load, predict, assignment, re-track and both exports, crops,
    tracklets, reassignments and peak device memory.
13. VI training (``vi_train``): the port's ``Segmenter`` converts
    ``synth_frames(128, n_fish=15, size=512)`` (15 distinct stamps) with
    detection on the card under ``product_settings(15)`` and
    ``track_engine=auto``; the CLI runs ``-task track -auto_train
    -auto_quit -visual_identification_save_images true
    -recognition_save_progress_images true``: ``auto`` picks the object
    Tracker, the accumulation curriculum trains the registry's network
    (v118_3 at 80x80, one class per individual, bfloat16 compute, batch
    128) with the registry's training settings on the card, then the
    network is applied (no identity needs a correction on this scene).
    A second track task with ``-auto_apply`` swaps two identities at
    frame 64 by manual matches and applies the trained weights, which
    reassign them, so the video is re-tracked. Held: one train step on
    a 128-batch of the saved training images, card against the port's
    CPU path from the same weights with dropout 0 (loss, every gradient
    and the BatchNorm statistics within ``tests/test_torch_vi_train.py``'s
    bfloat16 tolerances); the saved weights loaded into a CPU
    ``VITrainer`` give the card's rows on the discrimination set within
    :data:`VI_PROB_TOL`; the saved training images are the crops of the
    trained ranges; the first step's last epoch has a lower mean loss
    than its first; the uniqueness after training is above the untrained
    network's; the apply reassigned identities and a re-track ran, which
    gave the two swapped identities the first track's blobs back, and
    its .results and npz files load again. Ms per
    training step and images/s on the card, epochs and steps per
    accumulation step with its status and reason, uniqueness before and
    after, seconds of the accumulation, save, apply and re-track, peak
    device memory.
14. Visual fields and the closed loop (``vf``): phase 11's .pv and
    .results (251 individuals over 64 frames, posture from the object
    Tracker); the CLI runs ``-task track -load -output_visual_fields true
    -auto_quit`` with two view-blocking ``visual_field_shapes``
    (:data:`VF_SHAPES`), the projection (B11, ``ops/raycast.py``) on the
    card. At frames 0, 21, 42 and 63 the export holds the card's planes,
    and the card's planes equal the port's CPU path's but in cells whose
    deciding point lies within a few ulps of a bin or depth-level edge
    (:func:`vf_departures`; counted, ``ROADMAP.md`` C6). ``TrackingState``
    runs the live loop over the first 16 frames with a user module that
    requests positions, midlines and visual fields: every frame reaches
    it, and its planes at frame 8 are the card's. ``track_video_hybrid``
    on phase 4's chunk cut to 16 frames takes the engine the scan's flags
    pick (the host FastTracker at 256 fish, held to a FastTracker run on
    the same frames) and on a sparse 64-fish chunk the card's (held to
    ``track_video_device``). Seconds of the export, host and total
    milliseconds a frame, the raycast's device time a frame (CUDA events)
    with its eyes and points, peak device memory, the loop's seconds a
    frame, the hybrid's engine and seconds.
15. Physical tags (``tags``): 256 fish at 1024^2 over 32 frames, the
    stamps at :data:`TAG_SCALE` (26-34 x 16-20 px), each fish carrying
    its own 12x12 code of an 8-bit id (:func:`tag_code`, a seeded
    permutation of 0-255) 6 px beside its stamp, under
    :func:`tag_settings` (the size filter keeps the fish and leaves the
    codes as noise, ``cm_per_pixel`` puts them inside
    ``tags_size_range``). The port's ``train_tag_decoder`` trains the
    default tag network (``TagDecoderNet(256, 32)``: 16/32/64 filters, a
    1024x256 dense layer) on the card from :func:`tag_crops` (32
    rendered crops an id with sub-pixel jitter up to
    :data:`TAG_JITTER` and noise, through ``prettify_blobs``), and the
    port's HDF5 writer saves it; the ``Segmenter`` converts with
    detection on the card; the CLI runs ``-task track -tags_recognize
    true -tags_model_path <h5> -tags_path tags -tags_save_predictions
    true -auto_quit`` (``auto`` picks the object Tracker, both fast
    engines refuse ``tags_recognize``; the network decodes each frame's
    tags in one forward on the card), then ``-task track -load
    -auto_tags true -auto_quit``. Held: the decoder's accuracy at least
    :data:`TAG_MIN_ACCURACY` on two held-out rendered sets, one at the
    training offsets and one on the pixel grid as the scene's codes
    sit; at frames :data:`TAG_HELD_FRAMES` each frame's tag crops
    through the card and the port's CPU path, logits within
    :data:`TAG_RTOL`/:data:`TAG_ATOL` and ids equal wherever the top-two
    margin exceeds twice that tolerance; the .h5 read back bit for bit;
    the tags npz and the PNGs (decoded by :func:`read_png_gray`) hold the
    tags' crops; the .results carries the tags; ``-auto_tags``
    reassigned identities and re-tracked, and the share of tracked
    (frame, identity) pairs whose identity is the tag id the scene gave
    that fish rose. Candidates, tags past the variance gate, past the
    shape test and decoded a frame; host-clock seconds a frame of the
    crops and gates and of the decode calls (the copies to and from the
    card, the forward and the wait; the card's own time of one frame's
    decode is ``torch_profile.py``'s ``tag_decode_256``); training ms a
    step and images/s; seconds of the track task, of ``-auto_tags`` and
    of its re-track; peak device memory.
16. YOLO detection and posture from predictions (``yolo``): a random
    YOLOv8x pose model with 5 keypoints and one class
    (:func:`write_yolo_pt`: ultralytics' checkpoint layout, seeded
    weights, BatchNorm statistics of the scene, the class prior set so
    that about as many anchors pass as the scene shows fish) loaded by
    the port's ``load_ultralytics_checkpoint`` through
    ``create_detection``, whose ``apply`` runs over 64 frames of
    :func:`synth_scene` (1024^2, 256 fish) letterboxed whole to 640 and
    as SAHI tiles (``detect_tile_image`` 2, overlap 0.1, the four tiles
    in one batch; 16 frames when the script is past
    :data:`YOLO_LATE_S`). Frames/s, ms a 640 batch on the host clock
    and between CUDA events, rows above the threshold before NMS and
    detections after it a frame, host seconds a frame of
    ``_postprocess`` and ``merge_tile_detections``, peak memory. Held:
    two frames through the card and the port's CPU detector with the
    same weights (:func:`yolo_held`), in float32 within
    :data:`YOLO_F32_TOL`, in bfloat16 each layer within
    :data:`YOLO_ROW_TOL` on the same input and the rows within
    :data:`YOLO_BF16_TOL`, in both the detections agree wherever the
    scores lie beyond that bound of the threshold; no port kernel
    launched.
    Then :func:`prediction_pv` writes 64-frame ``.pv`` files of the
    scene whose blobs carry 5 pose keypoints along their stamp's long
    axis from the ground truth, or their own outline as
    ``original_outline``, and the CLI's ``-task track -auto_quit
    -track_engine object`` (:func:`pose_settings`: posture on,
    ``pose_midline_indexes`` 0-4) runs on each with the card and with
    ``device="cpu"``: npz and .results bytes equal, midlines on more
    than half of every frame's fish. Posture and adding seconds a
    frame, the share of a frame's fish with a midline, midline length
    over the blob's width.
17. Promptable segmentation (``sam``, cell sam-vitb-16x1024-32): a
    seeded random ViT-B SAM (:func:`write_sam_pth`: segment-anything's
    checkpoint layout, about 94 M parameters) through
    ``create_detection(detect_type="sam3")`` in bfloat16 on the card,
    one box prompt for each of 32 fish at frame 0 from the ground truth
    in ``detect_sam3_prompt``'s string format (:func:`sam_prompt`), the
    prompts kept over 16 frames of :func:`synth_scene` (1024^2, 256
    fish; 8 when the script reaches the phase past :data:`SAM_LATE_S`).
    Frames/s through ``apply``, encoder and decoder ms a frame between
    CUDA events, host ms a frame of the resizes and ``blobs_from_masks``,
    peak memory. Held (:func:`sam_held`): one frame in float32, card
    against the port's CPU path (embedding, mask logits and IoU within
    :data:`SAM_F32_TOL`, the masks' decisions equal but within
    :data:`SAM_MASK_MARGIN` of the threshold, blob and pixel counts);
    in bfloat16 each ViT block and the mask decoder on the CPU's input
    within :data:`SAM_ROW_TOL`, the whole forward by C8's rule
    (:data:`SAM_BF16_RATIO`); ``decode_text`` at full width on a random
    text tower (:func:`sam_text_held`); a ``Sam3ReplaySession`` over the
    frames (:func:`sam_session`). No port kernel launched. Alone:
    ``python3 -c 'import torch, chip_smoke;
    chip_smoke.phase_sam(torch.device("cuda", 0), {})'``.
18. Report: frames per second of phases 2-11, the replay's assist frames
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
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch.nn as nn

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
    bg, frames, _ = synth_scene(n_frames, n_fish, size, seed)
    return bg, frames


def synth_scene(n_frames, n_fish=N_FISH, size=SIZE, seed=0, codes=None,
                scale=1):
    """:func:`synth_frames` with each fish's top-left position a frame,
    (n_frames, n_fish, 2) as (x, y). With `codes` (one uint8 image a
    fish), each fish carries its code at :data:`TAG_OFFSET` (times
    `scale`) from its stamp's top-left corner. `scale` enlarges every
    stamp `scale` times a side, pixel for pixel; the positions and
    motion stay those of scale 1."""
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
        stamps.append(np.kron(st, np.ones((scale, scale), np.uint8)))
    bg = np.full((size, size), 200, np.uint8)
    frames = []
    track = []
    for _ in range(n_frames):
        img = bg.copy()
        vel += rng.normal(0, 0.6, vel.shape)
        np.clip(vel, -4, 4, out=vel)
        pos += vel
        over = (pos < 20) | (pos > size - 25)
        vel[over] *= -1
        pos = np.clip(pos, 20, size - 25)
        track.append(pos.copy())
        for k, (x, y) in enumerate(pos):
            st = stamps[k]
            xi, yi = int(x), int(y)
            region = img[yi:yi + st.shape[0], xi:xi + st.shape[1]]
            np.minimum(region, 200 - st[:region.shape[0], :region.shape[1]],
                       out=region)
            if codes is not None:
                cx = xi + TAG_OFFSET[0] * scale
                cy = yi + TAG_OFFSET[1] * scale
                c = codes[k]
                region = img[max(cy, 0):cy + c.shape[0],
                             max(cx, 0):cx + c.shape[1]]
                np.minimum(region, c[max(-cy, 0):][:region.shape[0],
                                                   max(-cx, 0):][
                               :, :region.shape[1]], out=region)
        frames.append(img)
    return bg, np.stack(frames), np.stack(track)


# where a tagged fish carries its code, from its stamp's top-left corner
# at scale 1: 3 px right of the widest stamp (17 px), so that the code is
# a blob of its own
TAG_OFFSET = (20, 1)
TAG_DARK, TAG_LIGHT = 10, 150


def tag_code(tid: int, scale: int = 1) -> np.ndarray:
    """The code of tag `tid` (0-255), 6 `scale` px a side: a dark frame
    around a 4x4 grid, bit b of the id a light 1x2 cell in row b // 2,
    each grid pixel `scale` px a side. Beside :func:`synth_scene`'s fish
    at the same scale (46-96 pixels times scale^2) a code has fewer (36
    times scale^2) and stays noise."""
    c = np.full((6, 6), TAG_DARK, np.uint8)
    for b in range(8):
        if (tid >> b) & 1:
            r, k = divmod(b, 2)
            c[1 + r, 1 + 2 * k:3 + 2 * k] = TAG_LIGHT
    return np.kron(c, np.ones((scale, scale), np.uint8))


def tag_crops(ids, per_id, seed=0, jitter=0.0625, noise=3.0):
    """Training crops of tag codes (:func:`tag_code` at
    :data:`TAG_SCALE`) as phase 15's tracker sees them: each code rendered at a sub-pixel offset of up to
    `jitter` px in steps of 1/16 (16x supersampled, area-averaged onto
    the pixel grid) on the scene's background, with Gaussian noise of
    `noise` grey levels, thresholded into a blob like the scene's
    detection (difference over 20) and cropped through
    ``prettify_blobs``. The first crop of each id sits on the grid
    without noise, as the scene's codes do. Returns
    (len(ids) * per_id, 32, 32) uint8 crops and their labels. An offset
    of 1/8 px or more can grow the code's box by a faint column or row
    (an eighth of the dark frame passes the threshold)."""
    from trex_tpu_torch.track.blob import TrackBlob
    from trex_tpu_torch.track.tags import prettify_blobs

    rng = np.random.default_rng(seed)
    up = 16
    side = 6 * TAG_SCALE + 10
    bg = np.full((side, side), 200, np.uint8)
    blobs, labels = [], []
    for tid in ids:
        code = np.kron(tag_code(int(tid), TAG_SCALE).astype(np.float64),
                       np.ones((up, up)))
        for k in range(per_id):
            dx, dy = (0, 0) if k == 0 else \
                np.rint(rng.uniform(-jitter, jitter, 2) * up).astype(int)
            canvas = np.full((side * up, side * up), 200.0)
            y0, x0 = 5 * up + dy, 5 * up + dx
            canvas[y0:y0 + code.shape[0], x0:x0 + code.shape[1]] = code
            img = canvas.reshape(side, up, side, up).mean(axis=(1, 3))
            if k:
                img = img + rng.normal(0, noise, img.shape)
            img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
            on = (200 - img.astype(np.int64)) > 20
            lines, px = [], []
            for y in np.flatnonzero(on.any(axis=1)):
                xs = np.flatnonzero(on[y])
                lines.append([y, xs[0], xs[-1]])
                px.append(img[y, xs[0]:xs[-1] + 1])
            blobs.append(TrackBlob(np.array(lines, np.int32),
                                   np.concatenate(px)))
            labels.append(int(tid))
    crops = np.stack([t.image for t in prettify_blobs(
        blobs, bg, max_size=[80, 80])])
    return crops, np.asarray(labels, np.int64)


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


# frames of the chunk whose posture pass phase 7 profiles (a depth cut:
# the profiler's cost grows with the events, about 30 s over 64 frames)
POSTURE_PROFILE_FRAMES = 16


def posture_chunk(dev, settings, fr, bgt):
    """``fused_scan_packed`` over the chunk with the posture pass and
    without it (``calculate_posture`` off), warm; then the posture pass
    alone under torch.profiler, over the detections and assignments of
    the chunk's first :data:`POSTURE_PROFILE_FRAMES` frames (profiling
    the scan too would cost the profiler tens of seconds; the scan and
    the pass are frame-sequential, so those frames are the chunk's).
    Returns the report and the unpacked history with posture."""
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
    Tp = min(T, POSTURE_PROFILE_FRAMES)
    fp = fr[:Tp]
    det = detections_from_runcc(detect_batch_runs(fp, bgt, device=dev, **kw),
                                P)
    carry0, pdir0, times, fidx = _aux_split(
        torch.as_tensor(aux, device=dev), T, P)
    hist, _ = _scan_impl(det, times[:Tp], fidx[:Tp], P, carry0, fp, bgt,
                         split)
    sync()
    t0 = time.perf_counter()
    again, launches, by_part, part_ms = launches_by_range(
        lambda: _posture_scan(fp, bgt, det, dict(hist), pdir0, P, spec),
        (POSTURE_RANGE,))
    profile_s = time.perf_counter() - t0
    h, _ = unpack_result(packed, T, P)
    check(np.array_equal(again["p_ok"].cpu().numpy(), h["p_ok"][:Tp]),
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
        profile_frames=Tp,
        posture_launches_per_frame=None if launches is None
        else by_part[POSTURE_RANGE] / Tp,
        posture_device_ms_per_frame=None if launches is None
        else part_ms[POSTURE_RANGE] / Tp,
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


def phase_decay(dev, report, bg, frames, dt_frames=(32, 16)):
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
    (with `keep`) return value are kept under the attribute's name."""

    def __init__(self, *targets, keep=True):
        self.targets, self.keep = targets, keep
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
                if self.keep:
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
                load_s=spy.seconds["load_results"], results=kept,
                runs=len(spy.returned["run"]))


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
    CLI also tracks a video a quarter longer, and the frame at which the
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
    bg, long_frames = synth_frames(n_frames + n_frames // 4)
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

    # video length: the same scene over 1.25 * n_frames frames, detected on
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


# The VI phase's network (v118_3 at 80x80, one class per individual): its
# head is tests/test_torch_vi_apply.py's nearest-prototype head, scaled by
# the factor that test states, and its rows are held to the port's CPU
# forward within the bfloat16 policy's row tolerance that
# tests/test_torch_vi_network.py (ROW_TOL) and that test state.
VI_SEED = 12
VI_HEAD_SCALE = 12.0
VI_PROB_TOL = 0.02
VI_BATCH = 512
# depth of the VI phase's re-track (analysis_range) and of its CPU hold:
# the first 32 of phase 11's 64 frames, which keeps the script near half
# its time limit; the network predicts all 64
VI_FRAMES = 32


def vi_features(model, x):
    """The penultimate features (relu of LayerNorm_0) of NCHW images."""
    import torch

    out = []
    hook = model.LayerNorm_0.register_forward_hook(
        lambda m, i, o: out.append(torch.relu(o)))
    try:
        model(x)
    finally:
        hook.remove()
    return out[0]


def vi_prototype_head(trainer, crops_by_fid, dev):
    """tests/test_torch_vi_apply.py's head: class k scores the projection
    of the features on the direction of individual (k + 1)'s mean
    features from the mean of all, times VI_HEAD_SCALE."""
    import torch

    ids = sorted(crops_by_fid)
    with torch.no_grad():
        protos = torch.stack([
            vi_features(trainer.model, torch.from_numpy(
                crops_by_fid[f]).to(dev).permute(0, 3, 1, 2)).float()
            .mean(0) for f in ids])
        mu = protos.mean(0)
        u = protos - mu
        u = u / u.norm(dim=1, keepdim=True)
        u = torch.roll(u, -1, 0)  # class k <- individual k + 1
        head = trainer.model.Dense_1
        head.weight.copy_(VI_HEAD_SCALE * u)
        head.bias.copy_(-VI_HEAD_SCALE * (u @ mu))


def vi_decided(preds, min_p, tol):
    """The tracklets whose correction no change of the rows within `tol`
    can alter (``auto_correct.assign_identities``' decisions): the best
    class beats the second, and the confidence the threshold, by more
    than 2 * tol, and every tracklet that may claim the same class over
    overlapping frames before it is itself decided and apart from it in
    confidence by more than 2 * tol."""
    m = 2 * tol
    claims = {}  # class -> tracklets that may claim it
    for i, tp in enumerate(preds):
        top = tp.probs.max()
        if top >= min_p - m:
            for c in np.flatnonzero(tp.probs >= top - m):
                claims.setdefault(int(c), []).append(i)
    decided = set()
    for i in sorted(range(len(preds)), key=lambda i: -preds[i].confidence):
        tp = preds[i]
        p = np.sort(tp.probs)
        ok = p[-1] - p[-2] > m and abs(tp.confidence - min_p) > m
        if ok and tp.confidence >= min_p:
            t0, t1 = tp.range
            for j in claims.get(tp.best_id, ()):
                o = preds[j]
                if j == i or o.range[1] < t0 or o.range[0] > t1 \
                        or o.confidence < tp.confidence - m:
                    continue
                if abs(o.confidence - tp.confidence) <= m \
                        or j not in decided:
                    ok = False
                    break
        if ok:
            decided.add(i)
    return [preds[i] for i in sorted(decided)]


def phase_vi(dev, report, proto_every=8):
    """VI apply (``vi``): phase 11's .pv and .results (256 fish at 1024^2,
    64 frames, the object Tracker), a v118_3 network at 80x80 with one
    class per loaded individual made from a seeded torch.Generator, its
    head the CPU twin test's prototype head (scaled by VI_HEAD_SCALE) and
    saved with the port's save_weights as ``o_weights.npz``; the port's
    CLI runs ``-task track -load -auto_apply -output_recognition_data true
    -output_tracklet_images true -auto_quit`` with the network on the
    card. Held: every prediction row the tracker stores to the port's CPU
    forward of the same crops (VI_PROB_TOL), the corrections to those the
    CPU rows give for every tracklet whose decisions have margins above
    twice that (:func:`vi_decided`: its top two classes, its confidence
    against the threshold and its order among the tracklets that may
    claim its class), and the re-tracked .results and npz files loading
    again."""
    import shutil

    import torch

    import trex_tpu_torch.export.export as export
    import trex_tpu_torch.ml.auto_correct as auto_correct
    from trex_tpu_torch.export.results import load_results
    from trex_tpu_torch.models import VITrainer, build
    from trex_tpu_torch.ops.crops import crops_for_individual
    from trex_tpu_torch.pipeline import TrackingState

    src = REPO / "build" / "smoke_object"
    root = REPO / "build" / "smoke_vi"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.copy(src / "o.pv", root / "o.pv")
    shutil.copy(src / "track" / "o.results", root / "o.results")
    values = object_settings()
    t_phase = time.perf_counter()

    # the loaded state: one class per individual; the prototypes' crops
    s = registry(dict(values, track_engine="object"))
    state = TrackingState(s, root / "o.pv", device=dev)
    load_results(state.tracker, root / "o.results")
    tr = state.tracker
    n = len(tr.individuals)
    min_p = float(s["match_min_probability"])
    check(n > 1, f"vi: -load restored {n} individuals")
    # every proto_every-th frame of each individual
    t0 = time.perf_counter()
    protos = {fid: crops_for_individual(ind, tr, s, frames={
        b.frame for b in ind.basic[::proto_every]})[0]
        for fid, ind in tr.individuals.items()}
    crop_s = time.perf_counter() - t0
    n_proto = sum(len(c) for c in protos.values())
    state.pv.close()
    check(all(len(c) for c in protos.values()),
          "vi: an individual without a crop")
    trainer = VITrainer(build("v118_3", n), n, (80, 80, 1),
                        generator=torch.Generator().manual_seed(VI_SEED),
                        device=dev)
    vi_prototype_head(trainer, protos, dev)
    trainer.save_weights(root / "o_weights.npz")

    # the network alone: warm, synchronised 512-image batches
    x = torch.from_numpy(np.random.default_rng(VI_SEED).integers(
        0, 256, (VI_BATCH, 1, 80, 80), dtype=np.uint8)).to(dev)
    with torch.no_grad():
        batch_ms = time_ms(lambda: trainer.model(x), iters=20, warmup=3)

    # the CLI run; every predict call's crops and rows are kept
    calls = []
    predict = VITrainer.predict

    def recorded(self, images, batch_size=VI_BATCH):
        rows = predict(self, images, batch_size)
        calls.append((np.asarray(images), rows))
        return rows
    torch.cuda.reset_peak_memory_stats(dev)
    VITrainer.predict = recorded
    try:
        with Spy((auto_correct, "predict_tracklets"),
                 (auto_correct, "assign_identities"),
                 (export, "export_recognition"),
                 (export, "export_tracklet_images")) as spy:
            run = track_cli(dev, root / "o.pv", root / "run", values,
                            "auto", ["-load", "-auto_apply",
                                     "-output_recognition_data", "true",
                                     "-output_tracklet_images", "true",
                                     "-analysis_range",
                                     f"[0,{VI_FRAMES - 1}]"])
    finally:
        VITrainer.predict = predict
    peak = torch.cuda.max_memory_allocated(dev)
    preds = spy.returned["predict_tracklets"][0]
    corr = spy.returned["assign_identities"][0]
    rt = run["tracker"]
    check(len(calls) == 1 and len(preds) > 0 and corr.reassigned > 0
          and spy.seconds["export_recognition"] > 0,
          f"vi: {len(calls)} predict calls for {len(preds)} tracklets, "
          f"{corr.reassigned} reassigned")

    # every stored row against the CPU forward of the same crops
    crops, card = calls[0]
    stored = sum(len(v) for v in rt.predicted.values())
    check(stored == len(card) == sum(tp.samples for tp in preds)
          and np.isfinite(card).all() and card.shape == (len(crops), n),
          f"vi: {stored} stored rows, {card.shape} predicted")
    # the rows of the tracklets within the first VI_FRAMES frames
    ends = np.cumsum([tp.samples for tp in preds])
    inside = [tp.range[1] < VI_FRAMES for tp in preds]
    rows = np.concatenate([np.arange(e - tp.samples, e) for tp, e, i
                           in zip(preds, ends, inside) if i])
    cpu = VITrainer(build("v118_3", n), n, (80, 80, 1), device="cpu")
    cpu.load_weights(root / "o_weights.npz")
    t0 = time.perf_counter()
    ref = card.copy()
    ref[rows] = cpu.predict(crops[rows], batch_size=64)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(card[rows] - ref[rows]).max())
    check(err <= VI_PROB_TOL, f"vi: card rows depart from the CPU forward "
          f"by {err:.3g} (> {VI_PROB_TOL})")

    # the corrections of the CPU rows (the card's beyond VI_FRAMES), for
    # every tracklet within VI_FRAMES whose decisions have a margin
    cpu_preds = [auto_correct.TrackletPrediction(
        fid=tp.fid, range=tp.range, probs=ref[e - tp.samples:e].mean(0),
        samples=tp.samples) for tp, e in zip(preds, ends)]
    cpu_corr = auto_correct.assign_identities(cpu_preds, n,
                                              min_probability=min_p)

    def claims(c):
        return {(fid, t0_, t1_): cid for cid, rs in c.ranges.items()
                for t0_, t1_, fid in rs}
    want, got = claims(cpu_corr), claims(corr)
    held = [tp for tp in vi_decided(preds, min_p, VI_PROB_TOL)
            if tp.range[1] < VI_FRAMES]
    moved = [(tp.fid, tp.range) for tp in held
             if got.get((tp.fid, *tp.range)) != want.get((tp.fid,
                                                          *tp.range))]
    check(held and not moved, f"vi: {len(moved)} of {len(held)} tracklets "
          f"corrected otherwise than from the CPU rows: {moved[:5]}")

    # the re-tracked outputs load again
    npz = sorted((root / "run" / "data").glob("*.npz"))
    for f in npz:
        with np.load(f) as z:
            for k in z.files:
                z[k]
    check(any("_recognition_" in f.name for f in npz)
          and any(f.name.endswith("_tracklet_images.npz") for f in npz),
          f"vi: the run wrote {[f.name for f in npz][:8]}")
    s = registry(dict(values, track_engine="object"))
    again = TrackingState(s, root / "o.pv", device=dev)
    load_results(again.tracker, run["results"])
    again.pv.close()
    check(len(again.tracker.individuals) > 0,
          "vi: the re-tracked .results restored no individual")

    r = dict(individuals=n, tracklets=len(preds), crops=len(crops),
             reassigned=corr.reassigned, skipped=corr.skipped,
             identities=len(corr.ranges), held_tracklets=len(held),
             top2_margin_tracklets=int(sum(
                 np.diff(np.sort(tp.probs)[-2:])[0] > 2 * VI_PROB_TOL
                 for tp in preds)),
             held_rows=len(rows), max_row_err=err, crop_s=crop_s,
             proto_crops=n_proto, frames=VI_FRAMES,
             crops_per_s=n_proto / crop_s, batch_ms=batch_ms,
             images_per_s=VI_BATCH / (batch_ms / 1e3),
             predict_s=spy.seconds["predict_tracklets"],
             assign_s=spy.seconds["assign_identities"],
             retrack_s=run["track_s"], load_s=run["load_s"],
             recognition_s=spy.seconds["export_recognition"],
             tracklet_images_s=spy.seconds["export_tracklet_images"],
             export_s=run["export_s"], results_s=run["results_s"],
             cli_s=run["wall_s"], cpu_forward_s=cpu_s,
             peak_mem_gb=peak / 1e9, npz_files=len(npz),
             s=time.perf_counter() - t_phase)
    report["vi"] = r
    print(f"phase 12 ok: VI apply, v118_3 at 80x80 with {n} classes on "
          f"phase 11's {PRODUCT_FRAMES} frames, re-tracked over "
          f"{VI_FRAMES}: host crop path {r['crops_per_s']:.0f} "
          f"crops/s; network {r['images_per_s']:.0f} images/s, "
          f"{batch_ms:.3f} ms per {VI_BATCH}-batch on the card; CLI "
          f"{r['cli_s']:.2f} s (load {r['load_s']:.2f}, predict "
          f"{r['predict_s']:.2f}, assignment {r['assign_s']:.3f}, re-track "
          f"{r['retrack_s']:.2f}, recognition export "
          f"{r['recognition_s']:.2f}, tracklet images "
          f"{r['tracklet_images_s']:.2f}, .results {r['results_s']:.2f} s); "
          f"{len(crops)} crops, {len(preds)} tracklets, "
          f"{corr.reassigned} reassigned, {corr.skipped} skipped; "
          f"{len(rows)} rows within {err:.3g} of the CPU forward "
          f"({cpu_s:.1f} s), "
          f"{len(held)} tracklets corrected as from the CPU rows; peak "
          f"device memory {r['peak_mem_gb']:.2f} GB", flush=True)


# The VI training phase: tests/test_torch_vi_train.py's tolerances for
# the bfloat16 policy (BF16_TOL for the loss and the statistics,
# BF16_GRAD_TOL for the gradient vector in relative L2 norm, both against
# the other implementation), the scene (synth_frames' first 15 stamps are
# all distinct) and the frame at which the apply run swaps two identities
VI_TRAIN_FISH = 15
VI_TRAIN_FRAMES = 128
VI_TRAIN_SIZE = 512
VI_TRAIN_BATCH = 128
VI_BF16_TOL = 0.05
VI_BF16_GRAD_TOL = 0.4
VI_SWAP_FRAME = 64


def vi_float64(model):
    """`model` computing in float64 throughout (the exact reference)."""
    import torch

    model.double()
    for m in model.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    return model


def vi_no_dropout(model):
    from trex_tpu_torch.models.layers import Dropout

    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    return model


def vi_train_forward(model, x, y, n):
    """Loss, gradients (by parameter name) and BatchNorm statistics after
    one train-mode forward of `model` on NCHW `x`, all on the CPU in
    float64 for comparison."""
    import torch

    from trex_tpu_torch.models.training import softmax_cross_entropy

    dt = next(model.parameters()).dtype
    dev = next(model.parameters()).device
    loss = softmax_cross_entropy(model(x.to(dev, dt), train=True),
                                 y.to(dev), n)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    stats = {k: v.detach().double().cpu() for k, v in
             model.state_dict().items() if k.endswith((".mean", ".var"))}
    return (float(loss.detach()),
            {k: g.double().cpu() for k, g in zip(names, grads)}, stats)


def vi_rel_l2(got, want):
    """The relative L2 distance of `got` from `want`."""
    return float((got - want).norm() / want.norm())


def phase_vi_train(dev, report):
    """VI training (``vi_train``): the port's Segmenter converts
    ``synth_frames(128, n_fish=15, size=512)`` with detection on the
    card under ``product_settings(15)`` and ``track_engine=auto``; the
    CLI runs ``-task track -auto_train -auto_quit
    -visual_identification_save_images true
    -recognition_save_progress_images true`` with the registry's
    network (v118_3 at 80x80, one class per individual, bfloat16
    compute, batch 128) and training settings, training on the card,
    then applies the network; a second track task swaps two identities
    at VI_SWAP_FRAME by manual matches and runs ``-auto_apply`` with the
    trained weights, which reassign them and re-track. Held: one train
    step on a 128-batch of the saved training images, card against the
    port's CPU path from the same weights with dropout 0 (the loss and
    the BatchNorm statistics within VI_BF16_TOL, the gradient vector
    within VI_BF16_GRAD_TOL in relative L2 norm); the saved weights loaded
    into a CPU VITrainer give the card's rows on the discrimination set
    within VI_PROB_TOL; the saved training images are the crops of the
    trained ranges; the first step's last epoch has a lower mean loss
    than its first; training raised the uniqueness above the untrained
    network's; the swapped run's apply reassigned identities and
    re-tracked, the re-track gave the swapped identities the first
    track's blobs back, and its .results and npz files load again."""
    import shutil

    import torch

    import trex_tpu_torch.ml as ml
    import trex_tpu_torch.pipeline as pipeline
    from trex_tpu_torch import kernels
    from trex_tpu_torch.export.results import load_results
    from trex_tpu_torch.ml import accumulation
    from trex_tpu_torch.models import VITrainer, build, vi_params
    from trex_tpu_torch.models.training import VITrainer as Trainer

    root = REPO / "build" / "smoke_vi_train"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    n_fish = VI_TRAIN_FISH
    values = dict(product_settings(n_fish), track_engine="auto")
    _, frames = synth_frames(VI_TRAIN_FRAMES, n_fish=n_fish,
                             size=VI_TRAIN_SIZE)
    t_phase = time.perf_counter()
    kernels.reset_launches()
    seg, convert_s = convert(dev, frames, root / "v.pv", values, False)
    check(seg.detector.frames == VI_TRAIN_FRAMES,
          f"vi_train: converted {seg.detector.frames} frames")

    # the CLI run, with the accumulation, every train call and the
    # steps of Adam they took kept
    kept = {}
    calls = []
    start, train = accumulation.Accumulation.start, Trainer.train

    def kept_start(self, *a, **kw):
        t0 = time.perf_counter()
        disc = self.generate_discrimination_data()
        kept["untrained"] = self.step_uniqueness(*disc)[2]
        kept["disc"] = disc
        kept["disc_s"] = time.perf_counter() - t0
        sync()
        t0 = time.perf_counter()
        res = start(self, *a, **kw)
        sync()
        kept["start_s"] = time.perf_counter() - t0
        kept["acc"], kept["result"] = self, res
        # the crops of the trained ranges, before the re-track moves the
        # identities
        kept["crops"] = [self._collect(r) for r in res.trained_ranges]
        return res

    def kept_train(self, *a, **kw):
        steps = self.steps
        sync()
        t0 = time.perf_counter()
        res = train(self, *a, **kw)
        sync()
        calls.append(dict(s=time.perf_counter() - t0, result=res,
                          steps=self.steps - steps, images=len(a[0])))
        return res
    torch.cuda.reset_peak_memory_stats(dev)
    accumulation.Accumulation.start, Trainer.train = kept_start, kept_train
    try:
        with Spy((ml, "check_tracklets_identities"),
                 (Trainer, "save_weights")) as spy:
            run = track_cli(dev, root / "v.pv", root / "run", values, "auto",
                            ["-auto_train",
                             "-visual_identification_save_images", "true",
                             "-recognition_save_progress_images", "true"])
    finally:
        accumulation.Accumulation.start, Trainer.train = start, train
    peak = torch.cuda.max_memory_allocated(dev)
    launches = dict(kernels.launches)
    acc, res = kept["acc"], kept["result"]
    n = acc.num_individuals
    tr = run["tracker"]
    check(type(tr).__name__ == "Tracker",
          f"vi_train: auto picked {type(tr).__name__}")
    check(res.steps and any(st.status.value == "added" for st in res.steps),
          f"vi_train: no accumulation step was added "
          f"({[(st.status.value, st.reason.value) for st in res.steps]})")
    check(kept["acc"].trainer.device.type == "cuda",
          "vi_train: the network trained off the card")

    # the saved files
    weights = root / "v_weights.npz"
    images_npz = root / "v_weights_training_images.npz"
    pngs = sorted(root.glob("v_weights_uniqueness_step*.png"))
    check(weights.is_file() and images_npz.is_file()
          and len(pngs) == len(res.progress_maps) > 0,
          f"vi_train: saved {sorted(p.name for p in root.iterdir())}")
    with np.load(images_npz) as z:
        saved_images, saved_labels = z["images"], z["labels"]
    want_images = np.concatenate([c[0] for c in kept["crops"]])
    want_labels = np.concatenate([c[1] for c in kept["crops"]])
    check(np.array_equal(saved_images, want_images)
          and np.array_equal(saved_labels, want_labels),
          "vi_train: the saved training images are not the crops of the "
          "trained ranges")

    # the first accumulation step learned
    first = calls[0]["result"].history
    check(first[-1]["loss"] < first[0]["loss"],
          f"vi_train: the first step's loss went from {first[0]['loss']} "
          f"to {first[-1]['loss']}")
    check(res.final_uniqueness > kept["untrained"],
          f"vi_train: uniqueness {res.final_uniqueness} after training, "
          f"{kept['untrained']} untrained")

    # the saved weights on the CPU against the card's rows
    disc_images, _ = kept["disc"]
    card_rows = acc.trainer.predict(disc_images)
    cpu = VITrainer(build("v118_3", n), n, (80, 80, 1), device="cpu")
    cpu.load_weights(weights)
    t0 = time.perf_counter()
    cpu_rows = cpu.predict(disc_images, batch_size=VI_TRAIN_BATCH)
    cpu_rows_s = time.perf_counter() - t0
    row_err = float(np.abs(card_rows - cpu_rows).max())
    check(np.isfinite(card_rows).all() and row_err <= VI_PROB_TOL,
          f"vi_train: the saved weights' CPU rows depart from the card's "
          f"by {row_err:.3g} (> {VI_PROB_TOL})")

    # one train step on a 128-batch of the training images: card against
    # the CPU from the same weights, dropout 0, against float64 on the CPU
    x = torch.from_numpy(saved_images[:VI_TRAIN_BATCH]).permute(0, 3, 1, 2) \
        .float()
    y = torch.from_numpy(saved_labels[:VI_TRAIN_BATCH].astype(np.int64))
    arrays = vi_params.to_flax_arrays(acc.trainer.model)
    models = {}
    for name, d in (("card", dev), ("cpu", "cpu"), ("f64", "cpu")):
        t = VITrainer(build("v118_3", n), n, (80, 80, 1), device=d)
        vi_params.from_flax_arrays(t.model, arrays)
        models[name] = vi_no_dropout(t.model)
    vi_float64(models["f64"])
    fw = {k: vi_train_forward(m, x, y, n) for k, m in models.items()}
    (lc, gc, sc), (lp, gp, sp), (lr, gr, sr) = fw["card"], fw["cpu"], \
        fw["f64"]
    loss_d = abs(lc - lp) / max(1.0, abs(lp))
    g_max = max(float(g.abs().max()) for g in gp.values())
    cat = [torch.cat([g[k].flatten() for k in sorted(gp)])
           for g in (gc, gp, gr)]
    grad_d = float((cat[0] - cat[1]).abs().max()) / g_max
    grad_l2 = vi_rel_l2(cat[0], cat[1])
    stat_d = []
    for k in sorted(sp):
        d = float((sc[k] - sp[k]).abs().max()) / max(
            1.0, float(sp[k].abs().max()))
        check(d <= VI_BF16_TOL,
              f"vi_train: BatchNorm statistic {k} departs by {d:.3g}")
        stat_d.append(d)
    check(loss_d <= VI_BF16_TOL and grad_l2 <= VI_BF16_GRAD_TOL,
          f"vi_train: one step's loss ({lc} card, {lp} CPU) or gradients "
          f"({grad_l2:.3g} in relative L2 norm) differ beyond the "
          f"bfloat16 tolerances")
    grad_f64 = [float(max((g[k] - gr[k]).abs().max() for k in gr)) / g_max
                for g in (gc, gp)]

    # the step alone on the card: a warm 128-batch of the training images
    trainer = acc.trainer
    xb, yb = x.to(dev), y.to(dev)
    snap = trainer.state
    step_ms = time_ms(lambda: trainer._train_step(
        trainer.opt, xb, yb, trainer._dropout_rng), iters=20, warmup=3)
    trainer.state = snap

    # the trained weights applied to a track in which identities 0 and 1
    # swap blobs at VI_SWAP_FRAME (manual matches): the apply reassigns
    # their tracklets from there and the run re-tracks
    f = VI_SWAP_FRAME
    first = {i: [tr.individuals[i].basic_stuff(k).blob.blob_id
                 for k in (f, VI_TRAIN_FRAMES - 1)] for i in (0, 1)}
    swap = {str(f): {"0": first[1][0], "1": first[0][0]}}
    first_reassigned = spy.returned["check_tracklets_identities"][0][1] \
        .reassigned
    with Spy((ml, "check_tracklets_identities")) as spy2:
        applied = track_cli(dev, root / "v.pv", root / "apply",
                            dict(values, manual_matches=swap), "auto",
                            ["-auto_apply"])
    corr = spy2.returned["check_tracklets_identities"][0][1]
    last = {i: applied["tracker"].individuals[i].basic_stuff(
        VI_TRAIN_FRAMES - 1).blob.blob_id for i in (0, 1)}
    restored = all(last[i] == first[i][1] for i in (0, 1))
    check(corr.reassigned > 0 and applied["runs"] == 2,
          f"vi_train: the swapped run's apply reassigned {corr.reassigned}"
          f" tracklets and tracked {applied['runs']} times")
    check(restored, f"vi_train: after the re-track identities 0 and 1 hold "
          f"blobs {last} at the last frame, the first track {first}")
    # the re-tracked outputs load again
    npz = sorted((root / "apply" / "data").glob("*.npz"))
    for path in npz:
        with np.load(path) as z:
            for k in z.files:
                z[k]
    s = registry(dict(values, track_engine="object"))
    again = pipeline.TrackingState(s, root / "v.pv", device=dev)
    load_results(again.tracker, applied["results"])
    again.pv.close()
    check(len(npz) > 0 and len(again.tracker.individuals) > 0,
          f"vi_train: the re-tracked run wrote {len(npz)} npz files, its "
          f".results {len(again.tracker.individuals)} individuals")

    steps = [dict(range=list(st.range), status=st.status.value,
                  reason=st.reason.value, uniqueness=st.uniqueness)
             for st in res.steps]
    train_calls = [dict(epochs=c["result"].epochs, steps=c["steps"],
                        images=c["images"], s=c["s"],
                        stopped_early=c["result"].stopped_early,
                        first_loss=c["result"].history[0]["loss"],
                        last_loss=c["result"].history[-1]["loss"])
                   for c in calls]
    train_s = sum(c["s"] for c in calls)
    n_steps = sum(c["steps"] for c in calls)
    runs = spy.seconds
    r = dict(fish=n_fish, frames=VI_TRAIN_FRAMES, size=VI_TRAIN_SIZE,
             individuals=n, convert_s=convert_s, cli_s=run["wall_s"],
             track_s=run["track_s"], accumulation_s=kept["start_s"],
             discrimination_s=kept["disc_s"], train_s=train_s,
             train_steps=n_steps, train_calls=train_calls,
             ms_per_step_in_run=1e3 * train_s / max(1, n_steps),
             step_ms=step_ms,
             images_per_s=VI_TRAIN_BATCH / (step_ms / 1e3),
             accumulation_steps=steps, success=res.success,
             untrained_uniqueness=kept["untrained"],
             final_uniqueness=res.final_uniqueness,
             save_s=runs["save_weights"],
             apply_s=runs["check_tracklets_identities"],
             export_s=run["export_s"], results_s=run["results_s"],
             training_images=len(saved_images),
             progress_images=len(pngs), max_row_err=row_err,
             cpu_rows_s=cpu_rows_s, loss_departure=loss_d,
             grad_departure=grad_d, grad_l2=grad_l2,
             grad_f64_card=grad_f64[0],
             grad_f64_cpu=grad_f64[1], stat_departure=max(stat_d),
             peak_mem_gb=peak / 1e9, kernel_launches=launches,
             npz_files=len(npz), first_reassigned=first_reassigned,
             swap_reassigned=corr.reassigned, swap_restored=restored,
             swap_cli_s=applied["wall_s"], swap_track_s=applied["track_s"],
             s=time.perf_counter() - t_phase)
    report["vi_train"] = r
    st_line = "; ".join(
        f"{st['range'][0]}-{st['range'][1]} {st['status']} "
        f"({st['reason']}, {st['uniqueness']:.3f})" for st in steps)
    call_line = ", ".join(f"{c['epochs']} epochs / {c['steps']} steps"
                          for c in train_calls)
    print(f"phase 13 ok: VI training, v118_3 at 80x80 with {n} classes "
          f"on {n_fish} fish, {VI_TRAIN_SIZE}^2, {VI_TRAIN_FRAMES} frames "
          f"(convert {convert_s:.2f} s): a {VI_TRAIN_BATCH}-batch step "
          f"{step_ms:.3f} ms on the card ({r['images_per_s']:.0f} "
          f"images/s; {r['ms_per_step_in_run']:.3f} ms a step in the run "
          f"with validation); accumulation {kept['start_s']:.2f} s "
          f"(discrimination set {kept['disc_s']:.2f} s), train calls "
          f"{call_line}; steps {st_line}; uniqueness untrained "
          f"{kept['untrained']:.3f}, final {res.final_uniqueness:.3f}, "
          f"success {res.success}; save {r['save_s']:.3f} s, apply "
          f"{r['apply_s']:.2f} s, tracking and re-track {run['track_s']:.2f}"
          f" s, CLI {run['wall_s']:.2f} s; {len(saved_images)} training "
          f"images = the trained ranges' crops, {len(pngs)} progress "
          f"images; saved weights on the CPU within {row_err:.3g} of the "
          f"card's rows; one step card vs CPU: loss {loss_d:.3g}, "
          f"gradients {grad_l2:.3g} in relative L2 norm, {grad_d:.3g} of "
          f"the largest (float64: card "
          f"{grad_f64[0]:.3g}, CPU {grad_f64[1]:.3g}), statistics "
          f"{max(stat_d):.3g}; {first_reassigned} identities reassigned; "
          f"the run with identities 0 and 1 swapped at frame {f}: "
          f"{corr.reassigned} reassigned, re-tracked, the first track's "
          f"blobs back (CLI {applied['wall_s']:.2f} s, tracking and "
          f"re-track {applied['track_s']:.2f} s); peak device memory "
          f"{r['peak_mem_gb']:.2f} GB; phase {r['s']:.1f} s", flush=True)




def vf_scene(seed, n_fish, n_points, shape_points=None, size=1000.0):
    """Inputs of ``ops/raycast.py::visual_field`` for a seeded scene:
    `n_fish` noisy ellipses of `n_points` points (a tenth of them
    padding) with two eyes each near their centre, and two point clouds
    standing in for tesselated shapes, of `shape_points` points each
    (100-2000 drawn when None)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(50, size - 50, (n_fish, 2))
    t = np.linspace(0, 2 * np.pi, n_points, endpoint=False)
    ring = np.stack([np.cos(t), np.sin(t)], -1)[None]
    r = rng.uniform(3, 12, (n_fish, 1, 1)) \
        * rng.uniform(0.5, 1.5, (n_fish, 1, 2))
    pts = (c[:, None, :] + r * ring).reshape(-1, 2)
    ids = np.repeat(np.arange(n_fish), n_points).astype(np.int32)
    valid = rng.random(len(ids)) < 0.9
    ids[~valid] = -1
    for j, m in enumerate(shape_points or [None, None]):
        m = int(rng.integers(100, 2000)) if m is None else m
        e = rng.uniform(0, size, 2) + rng.normal(0, 30, (m, 2))
        pts = np.concatenate([pts, e])
        ids = np.concatenate([ids, np.full(m, n_fish + j, np.int32)])
        valid = np.concatenate([valid, np.ones(m, bool)])
    eye_pos = c[:, None, :] + rng.normal(0, 4, (n_fish, 2, 2))
    eye_angle = rng.uniform(-4, 4, (n_fish, 2))
    return (pts.astype(np.float32), ids, valid, eye_pos.astype(np.float32),
            eye_angle.astype(np.float32), np.float32(math.hypot(size, size)))


# Phase 14's rule for the visual-field projection on the card against its
# CPU path: CUDA's atan2f is not the C library's, so a point within a few
# ulps of a bin edge can fall into the neighbouring bin (and, were the
# distances to differ, a depth level could move the same way). A cell of
# a layer departs when any of its planes differs; it is explained by a
# point of one of the cell's two ids that lies within VF_EDGE_ULPS
# float32 ulps (of pi for the angle, of the level for the depth) of the
# cell's bin edges or of a depth-level edge inside the bin. A layer-1
# cell is also explained by a layer-0 departure at the same cell, whose
# winner layer 1 excludes.
VF_EDGE_ULPS = 8


def vf_departures(inputs, got, want, n_bins=512):
    """Cells where `got` departs from `want` (the projection's planes
    with positional ids, numpy) on `inputs` (visual_field's arguments),
    with those no near-edge point explains. Returns dict(cells, id_cells,
    unexplained=[(fish, eye, bin, layer), ...])."""
    pts, pids, valid, eye_pos, eye_angle, max_d = inputs
    fov = math.radians(130.0)
    to_bin = n_bins / (2 * fov)
    tol_u = VF_EDGE_ULPS * float(np.spacing(np.float32(math.pi))) * to_bin
    levels = (1 << 13) - 1
    tol_v = VF_EDGE_ULPS * float(np.spacing(np.float32(levels)))
    pts = np.asarray(pts, np.float32)
    pids = np.asarray(pids)
    valid = np.asarray(valid, bool)
    cells = id_cells = 0
    unexplained = []
    departed0 = set()
    for layer in (0, 1):
        d = np.zeros(got[f"id{layer}"].shape, bool)
        for k in ("depth", "id", "fov"):
            d |= got[f"{k}{layer}"] != want[f"{k}{layer}"]
        id_cells += int((got[f"id{layer}"] != want[f"id{layer}"]).sum())
        for f, e, b in zip(*np.nonzero(d)):
            cells += 1
            if layer == 0:
                departed0.add((f, e, b))
            elif (f, e, b) in departed0:
                continue
            who = {int(got[f"id{layer}"][f, e, b]),
                   int(want[f"id{layer}"][f, e, b])} - {-1}
            sel = valid & np.isin(pids, list(who))
            dx = pts[sel, 0] - eye_pos[f, e, 0]
            dy = pts[sel, 1] - eye_pos[f, e, 1]
            ang = np.arctan2(dy.astype(np.float64), dx.astype(np.float64)) \
                - float(eye_angle[f, e])
            ang = np.mod(ang + math.pi, 2 * math.pi) - math.pi
            u = (ang + fov) * to_bin
            v = np.hypot(dx.astype(np.float64), dy.astype(np.float64)) \
                / float(max_d) * levels
            edge = (np.abs(u - b) <= tol_u) | (np.abs(u - b - 1) <= tol_u)
            inside = (u >= b - tol_u) & (u < b + 1 + tol_u)
            level = inside & (np.abs(v - np.round(v)) <= tol_v)
            if not (edge | level).any():
                unexplained.append((int(f), int(e), int(b), layer))
    return dict(cells=cells, id_cells=id_cells, unexplained=unexplained)



# Phase 14's view-blocking shapes (visual_field_shapes) inside the
# 1024^2 arena: a wall and a triangle
VF_SHAPES = [[[500, 100], [520, 100], [520, 900], [500, 900]],
             [[150, 700], [300, 650], [220, 850]]]
VF_HELD_FRAMES = (0, 21, 42, 63)
VF_LOOP_FRAMES = 16
VF_HYBRID_FRAMES = 16

VF_LOOP_MODULE = """
import numpy as np
frames = []
def request_features():
    return 'position,midline,visual_field'
def update_tracking(data):
    vf = data.visual_fields or {{}}
    frames.append(data.frame)
    np.savez({out!r} + f'/{{data.frame}}.npz', ids=data.ids,
             vf_ids=np.asarray(list(vf), np.int64),
             **{{f'{{k}}_{{fid}}': v for fid, p in vf.items()
                for k, v in p.items()}})
"""


def vf_held(dev, tracker, s, frame):
    """One frame's projection on the card and on the CPU from the same
    inputs: (ids, inputs, card planes, CPU planes), positional ids."""
    from trex_tpu_torch.ops.raycast import visual_field
    from trex_tpu_torch.track.visual_field import visual_field_inputs

    ids, inputs = visual_field_inputs(tracker, frame, s)
    card = {k: v.cpu().numpy()
            for k, v in visual_field(*inputs, device=dev).items()}
    cpu = {k: v.numpy()
           for k, v in visual_field(*inputs, device="cpu").items()}
    return ids, inputs, card, cpu


def phase_vf(dev, report, bg, frames):
    """Visual fields and the closed loop (``vf``): phase 11's .pv and
    .results (256 fish at 1024^2, 64 frames, 251 individuals with
    posture). The CLI's ``-task track -load -output_visual_fields true``
    with :data:`VF_SHAPES` exports every individual's planes, projected on
    the card; at :data:`VF_HELD_FRAMES` the card's planes equal the
    export's and the CPU path's but at bin and depth edges
    (:func:`vf_departures`). TrackingState runs the live loop over the
    first :data:`VF_LOOP_FRAMES` frames with a user module that requests
    positions, midlines and visual fields: every frame reaches it, and
    its planes at one frame are the card's. ``track_video_hybrid`` on
    phase 4's chunk cut to :data:`VF_HYBRID_FRAMES` frames (the engine the
    scan's flags pick, held to the host FastTracker or to
    ``track_video_device``) and on a sparse 64-fish chunk (the card's
    engine, held to ``track_video_device``)."""
    import shutil

    import torch

    import trex_tpu_torch.closed_loop as closed_loop
    import trex_tpu_torch.track.visual_field as vfmod
    from trex_tpu_torch.ops.device_tracker import (
        _history_from_fast_tracker, track_video_device, track_video_hybrid)
    from trex_tpu_torch.ops.raycast import _visual_field
    from trex_tpu_torch.pipeline import TrackingState
    from trex_tpu_torch.track.visual_field import map_ids

    src = REPO / "build" / "smoke_object"
    root = REPO / "build" / "smoke_vf"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    shutil.copy(src / "o.pv", root / "o.pv")
    shutil.copy(src / "track" / "o.results", root / "o.results")
    values = object_settings()
    t_phase = time.perf_counter()

    # 1. the export through the CLI, on the card
    with Spy((vfmod, "visual_field_inputs"),
             (vfmod, "compute_visual_fields"),
             (vfmod, "export_visual_fields")) as spy:
        run = track_cli(dev, root / "o.pv", root / "track", values, "auto",
                        ["-load", "-output_visual_fields", "true",
                         "-visual_field_shapes",
                         json.dumps(VF_SHAPES, separators=(",", ":"))])
    tr = run["tracker"]
    s = registry(dict(values, visual_field_shapes=VF_SHAPES))
    paths = spy.returned["export_visual_fields"][0]
    n_frames = len(spy.returned["visual_field_inputs"])
    check(len(paths) > 1 and n_frames == PRODUCT_FRAMES,
          f"vf: the export wrote {len(paths)} files over {n_frames} frames")
    exported = {}
    for p in paths:
        with np.load(p) as z:
            exported[p.name] = {k: z[k] for k in z.files}
    prefix = s["individual_prefix"] or "fish"
    held = {}
    dep_cells = dep_ids = 0
    for f in VF_HELD_FRAMES:
        ids, inputs, card, cpu = vf_held(dev, tr, s, f)
        dep = vf_departures(inputs, card, cpu)
        check(not dep["unexplained"],
              f"vf: frame {f}: card and CPU depart away from every bin and "
              f"depth edge at (fish, eye, bin, layer) "
              f"{dep['unexplained'][:5]}")
        dep_cells += dep["cells"]
        dep_ids += dep["id_cells"]
        mapped = map_ids(card, ids)
        for i, fid in enumerate(ids):
            e = exported[f"o_visual_field_{prefix}{fid}.npz"]
            j = int(np.nonzero(e["frames"] == f)[0][0])
            for k, v in mapped.items():
                check(np.array_equal(e[k][j], v[i]),
                      f"vf: frame {f}: the export's {k} of {fid} is not the "
                      "card's")
        held[f] = dict(fish=len(ids), points=int(len(inputs[0])),
                       eyes=2 * len(ids), departed_cells=dep["cells"],
                       departed_id_cells=dep["id_cells"],
                       shape_hits=int((card["id0"] >= len(ids)).sum()))

    # the projection alone on the card at frame 0's inputs: device time,
    # peak memory
    ids, inputs = vfmod.visual_field_inputs(tr, 0, s)
    t_in = [torch.as_tensor(np.asarray(a), device=dev) for a in inputs[:5]]
    t_in[1] = t_in[1].to(torch.int32)
    t_in[2] = t_in[2].to(torch.int32)
    max_d = float(inputs[5])
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _visual_field(*t_in, max_d)
    sync()
    peak = torch.cuda.max_memory_allocated(dev) - base
    ray_ms = time_ms(lambda: _visual_field(*t_in, max_d), iters=10)
    export_r = dict(
        frames=n_frames, s=spy.seconds["export_visual_fields"],
        files=len(paths), cli_s=run["wall_s"],
        host_s_per_frame=spy.seconds["visual_field_inputs"] / n_frames,
        frame_s=spy.seconds["compute_visual_fields"] / n_frames,
        raycast_ms=ray_ms, points=int(len(inputs[0])), eyes=2 * len(ids),
        pairs=2 * len(ids) * int(len(inputs[0])), peak_mem_gb=peak / 1e9,
        departed_cells=dep_cells, departed_id_cells=dep_ids, held=held)

    # 2. the live loop over the first frames, with a user module
    out = root / "loop"
    out.mkdir()
    module = root / "live_loop.py"
    module.write_text(VF_LOOP_MODULE.format(out=str(out)))
    ls = registry(dict(values, closed_loop_enable=True,
                       closed_loop_path=str(module)))
    state = TrackingState(ls, root / "o.pv", device=dev)
    with Spy((closed_loop.ClosedLoop, "update")) as lspy:
        t0 = time.perf_counter()
        state.run(frame_range=(0, VF_LOOP_FRAMES - 1))
        loop_wall = time.perf_counter() - t0
    state.pv.close()
    got = sorted(int(p.stem) for p in out.glob("*.npz"))
    check(got == list(range(VF_LOOP_FRAMES)),
          f"vf: the loop's module saw frames {got}")
    f = VF_LOOP_FRAMES // 2
    ids, inputs, card, cpu = vf_held(dev, state.tracker, ls, f)
    dep = vf_departures(inputs, card, cpu)
    check(not dep["unexplained"],
          f"vf: the loop's frame {f}: card and CPU depart at "
          f"{dep['unexplained'][:5]}")
    mapped = map_ids(card, ids)
    with np.load(out / f"{f}.npz") as z:
        check(z["vf_ids"].tolist() == list(ids),
              f"vf: the loop's frame {f} fields of {z['vf_ids'][:5]}")
        for i, fid in enumerate(ids):
            for k, v in mapped.items():
                check(np.array_equal(z[f"{k}_{fid}"], v[i]),
                      f"vf: the loop's {k} of {fid} at frame {f} is not the "
                      "card's")
    loop_r = dict(frames=VF_LOOP_FRAMES, wall_s=loop_wall,
                  update_s_per_frame=lspy.seconds["update"]
                  / VF_LOOP_FRAMES,
                  fields=len(ids), departed_cells=dep["cells"])

    # 3. track_video_hybrid: phase 4's chunk cut short, a sparse chunk
    hybrid_r = {}
    sbg, sframes = synth_frames(VF_HYBRID_FRAMES, n_fish=64, seed=0)
    for name, hbg, hframes, hs in (
            ("dense_256", bg, frames[:VF_HYBRID_FRAMES], track_settings()),
            ("sparse_64", sbg, sframes, track_settings(64))):
        t0 = time.perf_counter()
        h = track_video_hybrid(hframes, hbg, hs, device=dev, **TRACK_CAPS)
        wall = time.perf_counter() - t0
        d = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
             for k, v in track_video_device(hframes, hbg, hs, device=dev,
                                            **TRACK_CAPS).items()}
        flagged = bool(d["needs_host"].any() or d["detect_overflow"].any())
        check(h["engine"] == ("host" if flagged else "device"),
              f"vf: hybrid {name} took the {h['engine']} engine")
        if flagged:
            host, _ = host_track(hframes, hbg, hs)
            want = _history_from_fast_tracker(
                host, len(hframes), hs["track_max_individuals"])
        else:
            want = d
        for k in ("fish_x", "fish_y", "fish_seen", "n_assigned", "n_fish",
                  "needs_host"):
            check(np.array_equal(h[k], want[k]),
                  f"vf: hybrid {name} {k} != the {h['engine']} engine's")
        hybrid_r[name] = dict(engine=h["engine"], s=wall,
                              flagged_frames=int(d["needs_host"].sum()),
                              n_fish=int(h["n_fish"]))
    check(hybrid_r["sparse_64"]["engine"] == "device",
          "vf: the sparse chunk left the card's engine")

    r = report["vf"] = dict(export=export_r, loop=loop_r, hybrid=hybrid_r,
                            s=time.perf_counter() - t_phase)
    e = export_r
    print(f"phase 14 ok: visual fields of {len(tr.individuals)} "
          f"individuals over {n_frames} frames at {SIZE}^2 with "
          f"{len(VF_SHAPES)} shapes: export {e['s']:.2f} s ({e['files']} "
          f"files; {e['frame_s'] * 1e3:.1f} ms a frame, of which "
          f"{e['host_s_per_frame'] * 1e3:.1f} ms on the host for eyes and "
          f"tesselation); raycast {ray_ms:.3f} ms a frame on "
          f"the card for {e['eyes']} eyes x {e['points']} points, peak "
          f"device memory {e['peak_mem_gb']:.2f} GB; card vs CPU at frames "
          f"{list(VF_HELD_FRAMES)}: {dep_cells} cells departed "
          f"({dep_ids} in an id plane), each at a bin or depth edge; "
          f"closed loop over {VF_LOOP_FRAMES} frames "
          f"{loop_r['update_s_per_frame']:.3f} s a frame; hybrid "
          + ", ".join(f"{k} {v['engine']} {v['s']:.2f} s"
                      for k, v in hybrid_r.items())
          + f"; phase {r['s']:.1f} s", flush=True)


TAG_FISH = N_FISH
TAG_FRAMES = 32
TAG_HELD_FRAMES = (0, 10, 21, 31)
TAG_PER_ID = 32
TAG_EPOCHS = 12
TAG_BATCH = 128
TAG_LR = 1e-3
# the scene's stamps and codes at twice synth_frames' size a side: the
# codes 12 px a side, the fish 26-34 x 16-20 px
TAG_SCALE = 2
TAG_JITTER = 0.125   # px, the rendered crops' sub-pixel offsets
TAG_NOISE = 3.0      # grey levels, the rendered crops' noise
TAG_MIN_ACCURACY = 0.95   # tests/test_tagwork.py's
# the twin tolerance of the tag network's forward
# (tests/test_torch_tagwork.py: rtol 1e-4, atol 1e-3)
TAG_RTOL, TAG_ATOL = 1e-4, 1e-3


def tag_settings(n_fish=TAG_FISH):
    """A tagged recording's settings for :func:`synth_scene` with codes
    at :data:`TAG_SCALE`: grey storage, a ``max`` background, detection
    on the card, the tracker's background subtraction at threshold 20, a
    size filter (0.4-10 cm^2 at 0.05 cm a pixel: the fish hold 184-384
    pixels, 0.46-0.96 cm^2) that leaves the 144-pixel codes (0.36 cm^2,
    inside ``tags_size_range`` 0.08-2.0) as noise, no posture, and
    ``track_engine=auto``."""
    return dict(meta_encoding="gray", averaging_method="max",
                detect_engine="device", track_engine="auto", frame_rate=25,
                cm_per_pixel=0.1 / TAG_SCALE,
                track_size_filter=[[0.4, 10.0]],
                track_threshold=20, track_background_subtraction=True,
                detect_threshold=20, calculate_posture=False,
                track_max_individuals=n_fish)


def read_png_gray(path) -> np.ndarray:
    """An 8-bit grey, non-interlaced PNG as ``utils/drawing.write_png``
    writes it (every row filter 0), decoded without OpenCV."""
    import struct
    import zlib

    data = Path(path).read_bytes()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, color = struct.unpack(">IIBB", body[:10])
            check(depth == 8 and color == 0, f"{path}: not 8-bit grey")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    check(not raw[:, 0].any(), f"{path}: a row filter other than 0")
    return raw[:, 1:].copy()


def tag_identity_share(tracker, pos, tag_of_fish, max_px=12.0):
    """The share of tracked (frame, identity) pairs whose identity is the
    tag id of the scene's fish under its blob (the fish whose stamp
    centre, at :data:`TAG_SCALE`, lies nearest the blob's centroid,
    within `max_px`)."""
    n = pos.shape[1]
    half = TAG_SCALE * np.array([[(13 + k % 5) / 2, (8 + k % 3) / 2]
                             for k in range(n)])
    hits = pairs = 0
    for fid, ind in tracker.individuals.items():
        for b in ind.basic:
            f = b.frame
            if f >= len(pos):
                continue
            c = np.floor(pos[f]) + half
            d = np.hypot(*(c - np.asarray(b.centroid.pos)).T)
            k = int(np.argmin(d))
            pairs += 1
            hits += bool(d[k] <= max_px and tag_of_fish[k] == fid)
    return hits / max(pairs, 1), pairs


def phase_tags(dev, report):
    """Physical tags at full width (phase 15 of the module docstring)."""
    import shutil

    import torch

    import trex_tpu_torch.cli.trex as cli
    import trex_tpu_torch.ml.auto_tags as auto_tags
    from trex_tpu_torch import kernels
    from trex_tpu_torch.export.results_binary import read_results
    from trex_tpu_torch.io import hdf5
    from trex_tpu_torch.ml.tagwork import (Tagwork, load_keras_sequential_h5,
                                           save_keras_sequential_h5,
                                           train_tag_decoder)
    from trex_tpu_torch.track.tracker import Tracker

    root = REPO / "build" / "smoke_tags"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    n_ids = 256
    tag_of_fish = np.random.default_rng(15).permutation(n_ids)[:TAG_FISH]

    # 1. the decoder, trained on the card from rendered crops
    x, y = tag_crops(range(n_ids), TAG_PER_ID, seed=0, jitter=TAG_JITTER,
                     noise=TAG_NOISE)
    # held out: crops at the training offsets, and crops on the grid
    # with noise, as the scene's codes sit
    xh, yh = tag_crops(range(n_ids), 8, seed=1, jitter=TAG_JITTER,
                       noise=TAG_NOISE)
    xg, yg = tag_crops(range(n_ids), 8, seed=2, jitter=0.0,
                       noise=TAG_NOISE)
    # a short run first: cuDNN's and the fused Adam's first calls are
    # not the step's time
    train_tag_decoder(x[:2 * TAG_BATCH], y[:2 * TAG_BATCH], n_ids,
                      epochs=1, batch_size=TAG_BATCH, device=dev)
    sync()
    t0 = time.perf_counter()
    net = train_tag_decoder(x, y, n_ids, epochs=TAG_EPOCHS,
                            batch_size=TAG_BATCH, lr=TAG_LR, seed=0,
                            device=dev)
    sync()
    train_s = time.perf_counter() - t0
    steps = TAG_EPOCHS * -(-len(x) // TAG_BATCH)
    check(net.device.type == "cuda", "tags: the decoder trained off the card")
    h5 = root / "tags.h5"
    specs = net.layer_specs()
    save_keras_sequential_h5(h5, specs)
    # the .h5 read back bit for bit
    with hdf5.File(h5) as f:
        cfg = json.loads(f.attrs["model_config"].decode())
        check([(l["class_name"], l["config"]) for l in
               cfg["config"]["layers"]] == [(k, c) for k, c, _ in specs],
              "tags: the .h5's model_config differs from the layer specs")
        for kind, c, ws in specs:
            grp = f["model_weights"][c["name"]]
            names = [n.decode() for n in grp.attrs["weight_names"]]
            check(len(names) == len(ws), f"tags: {c['name']} weights")
            for n, w in zip(names, ws):
                got = grp[n][()]
                check(got.dtype == np.float32 and got.shape == w.shape
                      and got.tobytes() == np.asarray(w).tobytes(),
                      f"tags: {c['name']}/{n} did not read back bit for "
                      "bit")
    tw = Tagwork(32, 32, h5, device=dev)
    tw.load()
    accuracy = float((tw.predict(xh) == yh).mean())
    accuracy_grid = float((tw.predict(xg) == yg).mean())
    check(min(accuracy, accuracy_grid) >= TAG_MIN_ACCURACY,
          f"tags: the decoder's held-out accuracy {accuracy:.4f} at "
          f"{TAG_JITTER} px offsets, {accuracy_grid:.4f} on the grid; "
          f"< {TAG_MIN_ACCURACY}")

    # 2. the scene, converted with detection on the card
    values = tag_settings()
    _, frames, pos = synth_scene(TAG_FRAMES, n_fish=TAG_FISH, size=SIZE,
                                 codes=[tag_code(int(t), TAG_SCALE)
                                        for t in tag_of_fish],
                                 scale=TAG_SCALE)
    pv = root / "t.pv"
    _, convert_s = convert(dev, frames, pv, values, False)

    # 3. the track task with the tag network on the card
    flags = ["-tags_recognize", "true", "-tags_model_path", str(h5),
             "-tags_path", "tags", "-tags_save_predictions", "true"]
    run = track_cli(dev, pv, root / "track", values, "auto", flags)
    tr = run["tracker"]
    check(type(tr) is Tracker and "tags_recognize" in tr.engine_choice,
          f"tags: the track task picked {type(tr).__name__} "
          f"({getattr(tr, 'engine_choice', None)})")
    dec = tr.tag_decoder
    check(dec is not None and dec.tw.model.device.type == "cuda",
          "tags: the tag network did not run on the card")
    st = tr.tag_stats
    n_assigned = sum(len(v) for v in tr.tag_assignments.values())
    check(st.get("frames") == TAG_FRAMES and st["decoded"] > 0
          and n_assigned > 0,
          f"tags: the track task decoded no tags ({st}, {n_assigned})")

    # 4. card against the port's CPU path on the held frames' crops
    cpu = load_keras_sequential_h5(h5, device="cpu")
    by_frame = {}
    for fid, tags in tr.detected_tags.items():
        for t in tags:
            by_frame.setdefault(t.frame, []).append(t)
    held = dict(crops=0, decided=0, max_abs=0.0)
    for f in TAG_HELD_FRAMES:
        tags = by_frame.get(f, [])
        check(len(tags) > 0, f"tags: no tag matched at frame {f}")
        inv = 255.0 - np.stack([t.image for t in tags]).astype(np.float64)
        card = dec.tw.model.predict(inv)
        plain = cpu.predict(inv)
        err = np.abs(card - plain)
        tol = TAG_ATOL + TAG_RTOL * np.abs(plain)
        check((err <= tol).all(),
              f"tags: frame {f}: card logits depart from the CPU path's by "
              f"{err.max():.3g}")
        top2 = np.sort(plain, axis=1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * tol.max(axis=1)
        check((card.argmax(1)[sure] == plain.argmax(1)[sure]).all()
              and (card.argmax(1) == [t.tag_id for t in tags]).all(),
              f"tags: frame {f}: the card's ids depart from the CPU path's")
        held["crops"] += len(tags)
        held["decided"] += int(sure.sum())
        held["max_abs"] = max(held["max_abs"], float(err.max()))

    # 5. the exports: the tags npz, the PNGs, the .results' tag block
    out = root / "track"
    with np.load(out / "tags.npz") as z:
        for fid, tags in tr.detected_tags.items():
            check(np.array_equal(z[f"fish{fid}_images"],
                                 np.stack([t.image for t in tags]))
                  and np.array_equal(z[f"fish{fid}_ids"],
                                     [t.tag_id for t in tags]),
                  f"tags: the npz's fish{fid} differs from its tags")
    n_png = 0
    for fid, tags in tr.detected_tags.items():
        for t in tags:
            png = out / "tags_t" / f"tag {t.tag_id}" / \
                f"f{t.frame}_id{fid}.png"
            check(np.array_equal(read_png_gray(png), t.image),
                  f"tags: {png} does not decode to its crop")
            n_png += 1
    res_tags = read_results(run["results"]).tags
    n_res = sum(len(d) for d in res_tags.values())
    check(n_res > 0 and all(
        tid in tr.tag_assignments.get(f, {}).values()
        for tid, d in res_tags.items() for f in d),
        "tags: the .results carries no tags or others than the tracker's")

    # 6. -load -auto_tags: identities from the stored tags, re-track
    share_before, pairs_before = tag_identity_share(tr, pos, tag_of_fish)
    shutil.copy(run["results"], pv.with_suffix(".results"))
    with Spy((cli, "_auto_tags"), (auto_tags, "apply_tags")) as spy:
        fix = track_cli(dev, pv, root / "auto_tags", values, "auto",
                        ["-load", "-auto_tags", "true"])
    _, corr = spy.returned["apply_tags"][0]
    rt = fix["tracker"]
    check(corr.reassigned > 0 and fix["runs"] == 1,
          f"tags: -auto_tags reassigned {corr.reassigned} tracklets, "
          f"{fix['runs']} re-tracks")
    share_after, pairs_after = tag_identity_share(rt, pos, tag_of_fish)
    check(share_after > share_before,
          f"tags: -auto_tags left the share of identities equal to their "
          f"tag ids at {share_after:.3f} (before {share_before:.3f})")
    peak = torch.cuda.max_memory_allocated(dev)

    r = dict(
        fish=TAG_FISH, frames=TAG_FRAMES, ids=n_ids,
        train=dict(images=len(x), epochs=TAG_EPOCHS, steps=steps,
                   s=train_s, ms_per_step=train_s / steps * 1e3,
                   images_per_s=TAG_EPOCHS * len(x) / train_s,
                   held_out_accuracy=accuracy,
                   held_out_grid_accuracy=accuracy_grid,
                   held_out=len(xh) + len(xg)),
        per_frame=dict(
            candidates=st["candidates"] / TAG_FRAMES,
            past_variance=st["variance"] / TAG_FRAMES,
            past_shape=st["shape"] / TAG_FRAMES,
            decoded=st["decoded"] / TAG_FRAMES,
            matched=n_assigned / TAG_FRAMES,
            host_s=st["host_s"] / TAG_FRAMES,
            decode_wall_s=st["decode_s"] / TAG_FRAMES,
            decode_calls=dec.calls),
        held=held, convert_s=convert_s, track_s=run["wall_s"],
        tracking_s=run["track_s"], auto_tags_s=spy.seconds["_auto_tags"],
        retrack_s=fix["track_s"], load_s=fix["wall_s"],
        reassigned=corr.reassigned, identities=len(corr.ranges),
        share_before=share_before, share_after=share_after,
        pairs=(pairs_before, pairs_after), pngs=n_png, results_tags=n_res,
        peak_mem_gb=peak / 1e9, kernel_launches=dict(kernels.launches),
        s=time.perf_counter() - t_phase)
    report["tags"] = r
    pf = r["per_frame"]
    print(f"phase 15 ok: tags at {TAG_FISH} fish, {SIZE}^2, {TAG_FRAMES} "
          f"frames, {6 * TAG_SCALE} px codes: decoder trained on the card "
          f"({len(x)} crops, {steps} steps, "
          f"{r['train']['ms_per_step']:.3f} ms a step, "
          f"{r['train']['images_per_s']:.0f} images/s), held-out accuracy "
          f"{accuracy:.4f} at {TAG_JITTER} px offsets and "
          f"{accuracy_grid:.4f} on the grid; a frame "
          f"{pf['candidates']:.1f} candidates, "
          f"{pf['past_variance']:.1f} past the variance gate, "
          f"{pf['past_shape']:.1f} past the shape test, {pf['decoded']:.1f} "
          f"decoded, {pf['matched']:.1f} matched; host clock "
          f"{pf['host_s'] * 1e3:.2f} ms of crops and gates and "
          f"{pf['decode_wall_s'] * 1e3:.3f} ms of decode calls (copies, "
          f"forward, wait) a frame; card == CPU on "
          f"{held['crops']} crops of frames {list(TAG_HELD_FRAMES)} (max "
          f"{held['max_abs']:.3g}, {held['decided']} decided ids equal); "
          f"track task {r['track_s']:.2f} s, -auto_tags {r['load_s']:.2f} s "
          f"(re-track {r['retrack_s']:.2f} s, {corr.reassigned} "
          f"reassigned); identity == tag id {share_before:.4f} -> "
          f"{share_after:.4f}; {n_png} PNGs, {n_res} .results tags; peak "
          f"{peak / 1e9:.2f} GB; phase {r['s']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase 16: YOLO detection and posture from pose and outline predictions
# ---------------------------------------------------------------------------

YOLO_SCALE = "x"           # the widest scale the repo supports
YOLO_KEYPOINTS = 5
YOLO_FRAMES = 64
YOLO_CUT_FRAMES = 16       # part (a)'s frames when the script runs late
YOLO_LATE_S = 900.0
YOLO_HELD_FRAMES = 2
YOLO_ROW_TOL = 0.02        # tests/test_torch_yolo.py ROW_TOL
YOLO_F32_TOL = 1e-3        # float32 card against CPU: scores, and boxes
                           # and keypoints that times 640 px
# bfloat16, card against CPU. Each layer on the same input holds
# YOLO_ROW_TOL (0.0042 read); the whole forward does not: the few
# outputs of a layer that round to another bfloat16 on the two sides
# grow through this random x model's 112 layers, so that each side's
# bfloat16 rows lie about as far from the float32 rows as from each
# other (phase 16 prints both distances). The row bounds below are the
# readings on an NVIDIA H100 80GB HBM3 at 700 W (scores 0.156-0.162,
# boxes 2.9-5.7 px, keypoints 0.51-0.91 px) with a margin; the layer
# check and the mean distance from float32 are what a wrong forward
# fails.
YOLO_BF16_TOL = 0.2        # scores
YOLO_BF16_PX = 6.0         # boxes, px at 640
YOLO_BF16_KPT_PX = 1.0     # keypoints, px at 640
YOLO_BF16_RATIO = 1.25     # the card's bfloat16 rows' mean distance from
                           # the float32 rows over the CPU's (1.01 read)
YOLO_CLS_GAIN = 4.0        # the class head's last weights, times LeCun's
YOLO_KPT_GAIN = 0.1        # the keypoint head's, which keeps them near
                           # their anchors
YOLO_CONF = 0.1            # the registry's detect_conf_threshold
POSE_MIDLINE = [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# ultralytics' module layout, to write phase 16's checkpoint in
# ---------------------------------------------------------------------------

class ULConv(nn.Module):
    """ultralytics ``Conv``: conv (no bias) + BatchNorm2d (+ SiLU)."""

    def __init__(self, c1, c2, k=1, s=1):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3)


class ULBottleneck(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.cv1 = ULConv(c, c, 3)
        self.cv2 = ULConv(c, c, 3)


class ULC2f(nn.Module):
    def __init__(self, c1, c2, n):
        super().__init__()
        c = c2 // 2
        self.cv1 = ULConv(c1, 2 * c, 1)
        self.cv2 = ULConv((2 + n) * c, c2, 1)
        self.m = nn.ModuleList(ULBottleneck(c) for _ in range(n))


class ULSPPF(nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        self.cv1 = ULConv(c1, c1 // 2, 1)
        self.cv2 = ULConv(c1 // 2 * 4, c2, 1)


def _ul_branch(chs, c_mid, n_out):
    return nn.ModuleList(nn.Sequential(
        ULConv(c, c_mid, 3), ULConv(c_mid, c_mid, 3),
        nn.Conv2d(c_mid, n_out, 1)) for c in chs)


class ULProto(nn.Module):
    def __init__(self, c1, c_, c2):
        super().__init__()
        self.cv1 = ULConv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = ULConv(c_, c_, 3)
        self.cv3 = ULConv(c_, c2, 1)


class ULHead(nn.Module):
    """ultralytics' Detect / Segment / Pose / OBB head parameters."""

    def __init__(self, nc, chs, task="detect", num_keypoints=17,
                 kpt_dims=3, num_masks=32, width=0.25, reg_max=16):
        super().__init__()
        self.nc = nc
        self.stride = (8, 16, 32)
        self.cv2 = _ul_branch(chs, max(16, chs[0] // 4, reg_max * 4),
                              4 * reg_max)
        self.cv3 = _ul_branch(chs, max(chs[0], min(nc, 100)), nc)
        n_out = {"segment": num_masks, "pose": num_keypoints * kpt_dims,
                 "obb": 1}.get(task)
        if n_out is not None:
            self.cv4 = _ul_branch(chs, max(chs[0] // 4, n_out), n_out)
        if task == "segment":
            self.proto = ULProto(chs[0], max(8, int(round(256 * width / 8))
                                             * 8), num_masks)


def ultralytics_layout(num_classes: int, scale: str = "n",
                       task: str = "detect", num_keypoints: int = 17,
                       kpt_dims: int = 3) -> nn.Module:
    """A module holding a YOLOv8's parameters under ultralytics' names
    (``model.0`` .. ``model.22``, the head's cv2/cv3/cv4/proto), as a
    ``.pt`` checkpoint's ``model`` pickles them; it has no forward.
    ``torch.save({"model": m}, path)`` writes a file that
    the port's ``load_ultralytics_checkpoint`` reads."""
    from trex_tpu_torch.models.yolo import SCALES

    depth, width, maxc = SCALES[scale]

    def ch(c):
        return max(8, int(round(min(c, maxc) * width / 8) * 8))

    def nd(n):
        return max(1, round(n * depth))

    c = [ch(64), ch(128), ch(256), ch(512), ch(1024)]
    layers = [ULConv(3, c[0], 3, 2), ULConv(c[0], c[1], 3, 2),
              ULC2f(c[1], c[1], nd(3)), ULConv(c[1], c[2], 3, 2),
              ULC2f(c[2], c[2], nd(6)), ULConv(c[2], c[3], 3, 2),
              ULC2f(c[3], c[3], nd(6)), ULConv(c[3], c[4], 3, 2),
              ULC2f(c[4], c[4], nd(3)), ULSPPF(c[4], c[4]),
              nn.Identity(), nn.Identity(),
              ULC2f(c[4] + c[3], c[3], nd(3)), nn.Identity(),
              nn.Identity(), ULC2f(c[3] + c[2], c[2], nd(3)),
              ULConv(c[2], c[2], 3, 2), nn.Identity(),
              ULC2f(c[2] + c[3], c[3], nd(3)), ULConv(c[3], c[3], 3, 2),
              nn.Identity(), ULC2f(c[3] + c[4], c[4], nd(3)),
              ULHead(num_classes, [c[2], c[3], c[4]], task, num_keypoints,
                     kpt_dims, width=width)]
    root = nn.Module()
    root.model = nn.ModuleList(layers)
    return root


def write_yolo_pt(root, frames, device, scale=YOLO_SCALE,
                  num_keypoints=YOLO_KEYPOINTS, seed=16):
    """Two random single-class pose YOLOv8 checkpoints in ultralytics'
    layout (:func:`ultralytics_layout`, the module layout of
    ``tests/test_yolo_checkpoint.py``) under `root`, one for each way
    phase 16 detects (``{"letterbox": path, "tiles": path}``). They hold
    one network: convolutions LeCun-normal from a seeded generator, the
    class head's last layer :data:`YOLO_CLS_GAIN` and the keypoint
    head's :data:`YOLO_KPT_GAIN` times that (keypoints near their
    anchors, as a trained model's lie near its boxes), the box head's
    last biases 1.0 as ultralytics' ``Detect.bias_init`` sets them, and
    BatchNorm statistics from `frames` letterboxed and cut into their
    640 SAHI tiles (each layer's batch mean and variance, layer by
    layer, on `device`), as a trained model's come from its data: with
    statistics at the identity, a random network's features hardly vary
    over a scene of small animals, and its class scores either pass no
    anchor or pass them all. The class head's last biases are
    ``bias_init``'s prior (``log(5 / nc / (640 / stride)^2)``) moved by
    one amount per file, so that the class scores pass the threshold
    :data:`YOLO_CONF` on as many anchors as the scene shows fish: on
    :data:`N_FISH` an image letterboxed, and on the fish a tile's area
    holds at the scene's density in a tile (the mean over `frames` of
    each image's k-th largest logit lands on the threshold's logit).
    A trained model passes about one anchor a fish; ``bias_init``'s
    prior alone passes a handful an image here."""
    import torch

    from trex_tpu_torch.detect.tiling import compute_tile_bounds
    from trex_tpu_torch.detect.yolo import letterbox
    from trex_tpu_torch.models import yolo
    from trex_tpu_torch.models.layers import BatchNorm
    from trex_tpu_torch.models.yolo_convert import convert_state_dict

    m = ultralytics_layout(1, scale, "pose", num_keypoints)
    g = torch.Generator().manual_seed(seed)
    head = m.model[22]
    gain = {id(seq[2]): YOLO_CLS_GAIN for seq in head.cv3}
    gain.update({id(seq[2]): YOLO_KPT_GAIN for seq in head.cv4})
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, torch.nn.Conv2d):
                w = mod.weight
                std = gain.get(id(mod), 1.0) / math.sqrt(w[0].numel())
                w.copy_(torch.randn(w.shape, generator=g) * std)
                if mod.bias is not None:
                    mod.bias.copy_(torch.randn(mod.bias.shape,
                                               generator=g) * 0.01)
            elif isinstance(mod, torch.nn.BatchNorm2d):
                mod.weight.copy_(1 + 0.1 * torch.randn(mod.weight.shape,
                                                       generator=g))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape,
                                                 generator=g))
        for box, cls, st in zip(head.cv2, head.cv3, head.stride):
            box[2].bias.fill_(1.0)
            cls[2].bias.fill_(math.log(5 / head.nc / (640 / st) ** 2))
    # the statistics: the port's model on the checkpoint's tensors, each
    # BatchNorm set to its input's batch statistics as the forward
    # reaches it; the ultralytics name of each port name from the
    # converter's own map
    sd = m.state_dict()
    names = list(sd)
    index = convert_state_dict(
        {k: np.full(1, i, np.float32) for i, k in enumerate(names)},
        scale, "pose")
    ul_name = {k: names[int(v[0])] for k, v in index.items()}
    state = {k: sd[ul_name[k]] for k in index}
    model = yolo.build(1, scale, "pose", num_keypoints=num_keypoints,
                       dtype=torch.float32, state=state, device=device)

    def calibrate(mod, inputs, _out):
        x = inputs[0].float()
        mod.mean.copy_(x.mean((0, 2, 3)))
        mod.var.copy_(x.var((0, 2, 3), unbiased=False))
        mul = torch.rsqrt(mod.var + mod.epsilon) * mod.scale
        return (x - mod.mean[:, None, None]) * mul[:, None, None] \
            + mod.bias[:, None, None]

    hooks = [b.register_forward_hook(calibrate) for b in model.modules()
             if isinstance(b, BatchNorm)]
    # the frames letterboxed whole and their SAHI tiles, as the phase
    # detects them
    h, w = frames[0].shape[:2]
    tiles = compute_tile_bounds((w, h), (640, 640), 0, 2, 0.1)
    views = list(frames) + [f[y:y + th, x:x + tw] for f in frames
                            for x, y, tw, th in tiles]
    canvas = np.stack([letterbox(v, 640) for v in views])
    with torch.no_grad():
        out = model(torch.from_numpy(canvas).to(device).permute(0, 3, 1, 2))
        for hk in hooks:
            hk.remove()
        for k, t in model.state_dict().items():
            if k.endswith(".bn.mean") or k.endswith(".bn.var"):
                sd[ul_name[k]].copy_(t.cpu())
        logits = torch.cat([c.flatten(1) for c in out["classes"]], 1)
    logit_thr = math.log(YOLO_CONF / (1 - YOLO_CONF))
    n_lb = len(frames)
    per_tile = round(N_FISH * tiles[0][2] * tiles[0][3] / (h * w))
    paths = {}
    for view, rows, k in (("letterbox", logits[:n_lb], N_FISH),
                          ("tiles", logits[n_lb:], per_tile)):
        shift = logit_thr - float(rows.topk(k, 1).values[:, -1].mean())
        with torch.no_grad():
            for cls, st in zip(head.cv3, head.stride):
                cls[2].bias.fill_(math.log(5 / head.nc / (640 / st) ** 2)
                                  + shift)
        paths[view] = root / f"yolov8{scale}-pose-{view}.pt"
        torch.save({"model": m.eval()}, paths[view])
    return paths


def yolo_settings(model, **over):
    return dict(detect_type="yolo", detect_model=str(model),
                detect_resolution=640, detect_conf_threshold=YOLO_CONF,
                detect_batch_size=8, **over)


def stamp_keypoints(track_xy, k, n=YOLO_KEYPOINTS):
    """Fish `k`'s keypoints at its top-left position `track_xy`: `n`
    points along its stamp's long (x) axis through its middle row, as
    :func:`synth_scene` draws the stamp (``13 + k % 5`` by ``8 + k %
    3``)."""
    w, h = 13 + k % 5, 8 + k % 3
    xi, yi = int(track_xy[0]), int(track_xy[1])
    xs = xi + np.round(np.linspace(0, w - 1, n))
    return np.stack([xs, np.full(n, yi + h // 2)], 1)


def prediction_pv(path, bg, frames, track, kind, values, threshold=20):
    """A .pv of `frames` whose blobs (components darker than `bg` by
    `threshold`) carry a prediction each: ``pose``, the
    keypoints (:func:`stamp_keypoints`) of the fish whose stamp centre
    lies in the blob, from the scene's ground truth; ``outline``, the
    blob's own outline (its boundary pixels' centres, the ``original_
    outline`` of a segmentation model)."""
    from trex_tpu_torch.io.pv import PVFile, PVFrame, PVHeader
    from trex_tpu_torch.io.predictions import Prediction
    from trex_tpu_torch.ops.labeling import label_blobs
    from trex_tpu_torch.track.posture import trace_boundary

    n_fish = track.shape[1]
    sizes = np.array([(13 + k % 5, 8 + k % 3) for k in range(n_fish)])
    h, w = bg.shape
    header = PVHeader(encoding="gray", width=w, height=h, average=bg,
                      name=Path(path).stem, timestamp=1_700_000_000_000_000,
                      conversion_start=0, conversion_end=len(frames),
                      source="synth_scene")
    n_pred = 0
    with PVFile.create(path, header) as pv:
        pv.set_metadata({k: values[k] for k in ("frame_rate",
                                                "cm_per_pixel")})
        for i, img in enumerate(frames):
            fr = PVFrame(timestamp=40_000 * i, source_index=i, index=i)
            centres = np.floor(track[i]) + sizes / 2
            for b in label_blobs(img, bg, threshold, False):
                lines = np.asarray(b.lines, np.int32)
                fr.add_object(lines, b.pixels)
                pred = Prediction(clid=0, p=0.9)
                if kind == "pose":
                    x0, y0 = lines[:, 1].min(), lines[:, 0].min()
                    x1, y1 = lines[:, 2].max(), lines[:, 0].max()
                    inside = np.flatnonzero(
                        (centres[:, 0] >= x0) & (centres[:, 0] <= x1 + 1)
                        & (centres[:, 1] >= y0) & (centres[:, 1] <= y1 + 1))
                    if len(inside):
                        pred.pose = stamp_keypoints(track[i, inside[0]],
                                                    int(inside[0]))
                        n_pred += 1
                else:
                    x0, y0 = lines[:, 1].min(), lines[:, 0].min()
                    dense = np.zeros((lines[:, 0].max() - y0 + 1,
                                      lines[:, 2].max() - x0 + 1), np.uint8)
                    for y, a, e in lines:
                        dense[y - y0, a - x0:e - x0 + 1] = 1
                    pts = trace_boundary(dense) + np.array([x0, y0])
                    if len(pts) >= 3:
                        pred.original_outline = np.round(pts).astype(
                            np.int32).ravel()
                        n_pred += 1
                fr.predictions.append(pred)
            pv.add_frame(fr)
    return n_pred


def pose_settings(n_fish=N_FISH, track_threshold=0):
    """Tracking with posture from predictions: the base configuration's
    tracking, the posture variant, the keypoints' midline order, and
    `track_threshold` (the registry's 0 by default: the object Tracker
    keeps a blob's prediction only where it does not threshold the
    blob, as the JAX package's prefilter does; both fast engines need a
    threshold above 0)."""
    return dict(posture_settings(track_settings(n_fish)),
                pose_midline_indexes=POSE_MIDLINE, meta_encoding="gray",
                track_threshold=track_threshold)


class _Timed:
    """Wraps a YOLODetector's ``infer_device`` and ``_infer`` and the
    module's ``merge_tile_detections`` and ``_postprocess``: the host
    clock of each 640 batch (copies and the forward included), its
    device time between CUDA events, rows above the threshold before
    NMS, and the host seconds of the post-processing."""

    def __init__(self, det, yolo_mod):
        import torch

        self.det, self.mod, self.torch = det, yolo_mod, torch
        self.batch_host, self.events, self.before = [], [], []
        self.images = []
        self.post_s = self.merge_s = 0.0

    def __enter__(self):
        det, torch = self.det, self.torch
        infer_device, infer = det.infer_device, det._infer
        post, merge = det._postprocess, self.mod.merge_tile_detections

        def infer_device_t(canvas):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = infer_device(canvas)
            e1.record()
            self.events.append((e0, e1))
            return out

        def infer_t(canvas):
            self.images.append(len(canvas))
            t0 = time.perf_counter()
            out = infer(canvas)
            self.batch_host.append(time.perf_counter() - t0)
            return out

        def post_t(out, k, hw):
            t0 = time.perf_counter()
            self.before.append(int((out["conf"][k]
                                    >= det._conf_threshold).sum()))
            r = post(out, k, hw)
            self.post_s += time.perf_counter() - t0
            return r

        def merge_t(d, s):
            t0 = time.perf_counter()
            r = merge(d, s)
            self.merge_s += time.perf_counter() - t0
            return r

        det.infer_device, det._infer, det._postprocess = \
            infer_device_t, infer_t, post_t
        self.merge_tile_original = merge
        self.mod.merge_tile_detections = merge_t
        return self

    def __exit__(self, *exc):
        for name in ("infer_device", "_infer", "_postprocess"):
            del self.det.__dict__[name]
        self.mod.merge_tile_detections = self.merge_tile_original
        return False

    def device_ms(self):
        self.torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events]


def yolo_run(dev, backend, frames, yolo_mod):
    """`backend.apply` over `frames`: blobs a frame and the timings."""
    import torch

    t = _Timed(backend.detector, yolo_mod)
    dets = []
    apply_detect = backend.detector.detect

    def detect(img):
        d = apply_detect(img)
        dets.append(len(d))
        return d

    backend.detector.detect = detect
    try:
        backend.apply(0, frames[0])  # cuDNN's first calls
        dets.clear()
        with t:
            t.before.clear()
            sync()
            t0 = time.perf_counter()
            blobs = [len(backend.apply(i, img))
                     for i, img in enumerate(frames)]
            sync()
            wall = time.perf_counter() - t0
    finally:
        del backend.detector.__dict__["detect"]
    ms = t.device_ms()
    n = len(frames)
    return dict(frames=n, fps=n / wall, wall_s=wall,
                batches=len(ms), batch_size=max(t.images),
                batch_host_ms=1e3 * statistics.median(t.batch_host),
                batch_device_ms=statistics.median(ms),
                before_nms=sum(t.before) / n, after_nms=sum(dets) / n,
                blobs=sum(blobs) / n, postprocess_s=t.post_s / n,
                merge_s=t.merge_s / n,
                peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


def _nms_kept(rows, k, thr, iou):
    """The anchors of image `k` that ``YOLODetector._postprocess`` keeps
    (score at or above `thr`, then NMS at `iou`), as indices."""
    from trex_tpu_torch.detect.tiling import compute_tile_nms_indices

    idx = np.flatnonzero(rows["conf"][k] >= thr)
    sel = compute_tile_nms_indices(rows["boxes"][k][idx], rows["conf"][k][idx],
                                   rows["clid"][k][idx], iou)
    return idx[np.asarray(sel, int)]


def _iou_rows(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), 2)
    area = np.prod(a[:, 2:] - a[:, :2], 1)[:, None] \
        + np.prod(b[:, 2:] - b[:, :2], 1)[None]
    return np.where(area > inter, inter / np.maximum(area - inter, 1e-12),
                    0.0)


def yolo_detections_agree(det, g, c, frames, tol):
    """The card's detections (rows `g`) against the CPU's (`c`) on each
    frame: an anchor whose score lies further than `tol` from the
    threshold passes on both sides or on neither, and every detection
    with a score above the threshold by more than `tol` on one side is
    on the other side too, kept or suppressed there by a kept detection
    of the same class that overlaps it at NMS's IoU. The count of
    ``_postprocess``'s detections is that of the kept anchors on each
    side. Returns the anchors and detections compared."""
    thr = det._conf_threshold
    iou = float(det.settings["detect_iou_threshold"] or 0.7)
    near = np.abs(c["conf"] - thr) <= tol
    check(((g["conf"] >= thr) == (c["conf"] >= thr))[~near].all(),
          f"yolo: card and CPU pass different anchors beyond {tol} of the "
          f"threshold")
    clear = compared = 0
    for k, f in enumerate(frames):
        kept = {}
        for side, rows in (("card", g), ("cpu", c)):
            kept[side] = _nms_kept(rows, k, thr, iou)
            n = len(det._postprocess(rows, k, f.shape[:2]))
            check(n == len(kept[side]), f"yolo: frame {k}: {side} "
                  f"_postprocess gave {n} detections of "
                  f"{len(kept[side])} kept anchors")
        for side, other, rows in (("card", "cpu", g), ("cpu", "card", c)):
            mine = kept[side][rows["conf"][k][kept[side]] > thr + tol]
            theirs = kept[other]
            # on the other side: kept, or its box suppressed by a kept one
            orows = g if other == "card" else c
            ov = _iou_rows(orows["boxes"][k][mine],
                           orows["boxes"][k][theirs])
            same = orows["clid"][k][mine][:, None] \
                == orows["clid"][k][theirs][None]
            found = np.isin(mine, theirs) | ((ov >= iou) & same).any(1)
            check(found.all(), f"yolo: frame {k}: {int((~found).sum())} of "
                  f"the {side}'s detections clear of the threshold are "
                  f"not the {other}'s")
            clear += len(mine)
        compared += int((~near[k]).sum())
    return dict(anchors_compared=compared, detections_compared=clear,
                near_threshold=int(near.sum()),
                passed=int((g["conf"] >= thr).sum()))


def yolo_layers_held(card_model, cpu_model, canvas, dev):
    """Each ConvBNSiLU and each head's output convolution of the card's
    bfloat16 model, fed the input that layer had in the CPU's bfloat16
    forward of `canvas`, against the CPU layer's output: the largest
    difference over the largest magnitude, each at most
    :data:`YOLO_ROW_TOL`. A layer computed wrong on the card shows here
    without the whole network's amplification of rounding."""
    import torch

    from trex_tpu_torch.models.yolo import ConvBNSiLU

    names = [n for n, m in cpu_model.named_modules()
             if isinstance(m, ConvBNSiLU) or n.endswith("_2")]
    seen = {}
    cpu_mods = dict(cpu_model.named_modules())
    hooks = [cpu_mods[n].register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, (i[0], o)))
        for n in names]
    with torch.no_grad():
        cpu_model(torch.from_numpy(canvas).permute(0, 3, 1, 2))
        for h in hooks:
            h.remove()
        card_mods = dict(card_model.named_modules())
        worst, rel = "", 0.0
        for n in names:
            x, want = seen.pop(n)
            got = card_mods[n](x.to(dev)).float().cpu()
            want = want.float()
            r = float((got - want).abs().max()) \
                / max(float(want.abs().max()), 1e-30)
            if r > rel:
                worst, rel = n, r
    check(rel <= YOLO_ROW_TOL, f"yolo: bfloat16 layer {worst}: card != "
          f"CPU on the same input, {rel:.4g} > {YOLO_ROW_TOL}")
    return dict(layers=len(names), max_rel=rel, worst=worst)


def yolo_held(pt, dev, frames):
    """The card's detector against the port's CPU one, same weights, on
    `frames` letterboxed. float32 on both: decoded rows within
    :data:`YOLO_F32_TOL` (boxes and keypoints that times 640 px), and
    the detections agree (:func:`yolo_detections_agree`). bfloat16, the
    detector's default: each layer on the same input within
    :data:`YOLO_ROW_TOL` (:func:`yolo_layers_held`); the decoded rows
    within :data:`YOLO_BF16_TOL` of the CPU's (scores; boxes
    :data:`YOLO_BF16_PX`, keypoints :data:`YOLO_BF16_KPT_PX`) and, on
    average over the rows, no
    further from the float32 rows than :data:`YOLO_BF16_RATIO` times the
    CPU's bfloat16 rows are; the detections agree beyond
    :data:`YOLO_BF16_TOL` of the threshold."""
    import torch

    from trex_tpu_torch.detect.yolo import YOLODetector
    from trex_tpu_torch.models.yolo_convert import \
        load_ultralytics_checkpoint

    s = registry(yolo_settings(pt))
    out, rows = {}, {}
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        det = {}
        for side, d in (("card", dev), ("cpu", "cpu")):
            ck = load_ultralytics_checkpoint(pt, device=d)
            det[side] = YOLODetector(
                s, state=ck["state"], scale=ck["scale"], task=ck["task"],
                num_classes=ck["num_classes"],
                num_keypoints=ck["num_keypoints"], device=d, dtype=dtype)
        card, cpu = det["card"], det["cpu"]
        size = card.input_size
        canvas = np.stack([card._prepare(f, size) for f in frames])
        t0 = time.perf_counter()
        c = {k: v.float().cpu().numpy()
             for k, v in cpu.infer_device(canvas).items()}
        cpu_s = time.perf_counter() - t0
        g = {k: v.float().cpu().numpy()
             for k, v in card.infer_device(canvas).items()}
        rows[name] = (g, c)
        f32 = name == "float32"
        tol = YOLO_F32_TOL if f32 else YOLO_BF16_TOL
        px = YOLO_F32_TOL * size if f32 else YOLO_BF16_PX
        kpt_px = YOLO_F32_TOL * size if f32 else YOLO_BF16_KPT_PX
        err = dict(boxes=float(np.abs(g["boxes"] - c["boxes"]).max()),
                   scores=float(np.abs(g["scores"] - c["scores"]).max()),
                   kpt_xy=float(np.abs(g["keypoints"][..., :2]
                                       - c["keypoints"][..., :2]).max()),
                   kpt_conf=float(np.abs(g["keypoints"][..., 2]
                                         - c["keypoints"][..., 2]).max()))
        r = dict(err=err, cpu_s=cpu_s)
        if not f32:
            r["layers"] = yolo_layers_held(card.model, cpu.model, canvas,
                                           dev)
            ref = rows["float32"][1]
            r["from_f32"] = {}
            for key, part in (("boxes", np.s_[...]), ("scores", np.s_[...]),
                              ("keypoints", np.s_[..., :2])):
                gap = [np.abs(x[key][part] - ref[key][part]) for x in (g, c)]
                dist = [float(d.mean()) for d in gap]
                r["from_f32"][key] = dist + [float(d.max()) for d in gap]
                check(dist[0] <= YOLO_BF16_RATIO * dist[1],
                      f"yolo: bfloat16 {key}: the card's rows lie "
                      f"{dist[0]:.4g} from float32 on average, the CPU's "
                      f"{dist[1]:.4g}")
        check(err["boxes"] <= px and err["kpt_xy"] <= kpt_px
              and max(err["scores"], err["kpt_conf"]) <= tol,
              f"yolo: {name}: card != CPU beyond the bound: {err}")
        r.update(yolo_detections_agree(card, g, c, frames, tol))
        out[name] = r
        del det, card, cpu
        torch.cuda.empty_cache()
    return out


def phase_yolo(dev, report, t_script=0.0):
    """YOLO detection and posture from predictions (phase 16 of the
    module docstring)."""
    import shutil

    import torch

    import trex_tpu_torch.detect.yolo as yolo_mod
    from trex_tpu_torch import kernels
    from trex_tpu_torch.detect.base import create_detection

    root = REPO / "build" / "smoke_yolo"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    kernels.reset_launches()
    late = t_script > YOLO_LATE_S
    n_frames = YOLO_CUT_FRAMES if late else YOLO_FRAMES
    bg, frames, track = synth_scene(YOLO_FRAMES)

    # (a) detection at full width through the facade
    pts = write_yolo_pt(root, frames[:4], dev)
    t0 = time.perf_counter()
    whole = create_detection(registry(yolo_settings(pts["letterbox"])),
                             device=dev)
    load_s = time.perf_counter() - t0
    det = whole.detector
    check(det.task == "pose" and det.scale == YOLO_SCALE
          and det.model.num_keypoints == YOLO_KEYPOINTS
          and next(det.model.parameters()).device.type == "cuda",
          "yolo: the checkpoint did not load as an x pose model on the "
          "card")
    torch.cuda.reset_peak_memory_stats(dev)
    lb = yolo_run(dev, whole, frames[:n_frames], yolo_mod)
    tiled_backend = create_detection(registry(yolo_settings(
        pts["tiles"], detect_tile_image=2, detect_tile_overlap=0.1)),
        device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tiled = yolo_run(dev, tiled_backend, frames[:n_frames], yolo_mod)
    check(lb["after_nms"] > 0 and tiled["after_nms"] > 0,
          f"yolo: no detections ({lb['after_nms']}, {tiled['after_nms']})")
    held = yolo_held(pts["letterbox"], dev, frames[:YOLO_HELD_FRAMES])
    check(not any(kernels.launches.values()),
          f"yolo: a port kernel launched: {dict(kernels.launches)}")

    # (b) posture from pose and outline predictions through the CLI
    values = pose_settings()
    post = {}
    for kind in ("pose", "outline"):
        pv = root / kind / f"{kind}.pv"
        pv.parent.mkdir()
        n_pred = prediction_pv(pv, bg, frames, track, kind, values)
        run = track_cli(dev, pv, root / kind / "card", values, "object",
                        ["-output_posture_data", "true"])
        ref = track_cli("cpu", pv, root / kind / "cpu", values, "object",
                        ["-output_posture_data", "true"])
        got = output_files(root / kind / "card")
        want = output_files(root / kind / "cpu")
        check(got.keys() == want.keys() and got == want,
              f"yolo: {kind}: the card run's exports differ from the CPU "
              f"run's: {npz_departures(got, want)[0][:5]}")
        tr = run["tracker"]
        stats = [tr.statistics[f] for f in sorted(tr.statistics)]
        share, ratio = [], []
        for f in range(YOLO_FRAMES):
            n_here = n_mid = 0
            for ind in tr.individuals.values():
                basic = ind.basic_stuff(f)
                if basic is None:
                    continue
                n_here += 1
                ps = ind.posture_stuff(f)
                if ps is not None and ps.midline is not None:
                    n_mid += 1
                    ratio.append(ps.midline_length / basic.blob.bounds[2])
            share.append(n_mid / max(1, n_here))
        check(min(share) > 0.5, f"yolo: {kind}: midlines on only "
              f"{min(share):.3f} of a frame's fish")
        post[kind] = dict(
            predictions=n_pred, wall_s=run["wall_s"],
            track_s=run["track_s"],
            posture_s=sum(s.posture_seconds for s in stats) / YOLO_FRAMES,
            adding_s=sum(s.adding_seconds for s in stats) / YOLO_FRAMES,
            midline_share=(float(np.mean(share)), float(min(share))),
            length_ratio=(float(np.median(ratio)), float(np.min(ratio)),
                          float(np.max(ratio))),
            files=len(got))
    r = dict(scale=YOLO_SCALE, keypoints=YOLO_KEYPOINTS, cut=late,
             load_s=load_s, letterbox=lb, tiled=tiled, held=held,
             posture=post, kernel_launches=dict(kernels.launches),
             s=time.perf_counter() - t_phase)
    report["yolo"] = r

    def part(name, x):
        return (f"{name} {x['fps']:.2f} frames/s, {x['batches']} batches "
                f"of {x['batch_size']} at {x['batch_host_ms']:.1f} ms host "
                f"/ {x['batch_device_ms']:.1f} ms device, "
                f"{x['before_nms']:.1f} rows before NMS and "
                f"{x['after_nms']:.1f} detections a frame, post-process "
                f"{x['postprocess_s'] * 1e3:.1f} ms and merge "
                f"{x['merge_s'] * 1e3:.1f} ms a frame, peak "
                f"{x['peak_mem_gb']:.2f} GB")

    print(f"phase 16 ok: YOLOv8{YOLO_SCALE}-pose ({YOLO_KEYPOINTS} "
          f"keypoints) through create_detection over {n_frames} frames of "
          f"{SIZE}^2 with {N_FISH} fish"
          + (f" (cut from {YOLO_FRAMES}: the script was past "
             f"{YOLO_LATE_S:.0f} s)" if late else "")
          + f"; {part('letterboxed to 640:', lb)}; "
          f"{part('SAHI 2x2 tiles:', tiled)}; card == CPU on "
          f"{YOLO_HELD_FRAMES} frames: "
          + "; ".join(
              f"{k} boxes {v['err']['boxes']:.4g} px, scores "
              f"{v['err']['scores']:.4g}, keypoints {v['err']['kpt_xy']:.4g}"
              f" px, keypoint scores {v['err']['kpt_conf']:.4g} (CPU "
              f"forward {v['cpu_s']:.1f} s), {v['passed']} anchors passed, "
              f"{v['near_threshold']} near the threshold, "
              f"{v['anchors_compared']} anchors' and "
              f"{v['detections_compared']} detections' decisions equal"
              for k, v in held.items())
          + f"; bfloat16 layers on the same input: max "
          f"{held['bfloat16']['layers']['max_rel']:.4g} of "
          f"{held['bfloat16']['layers']['layers']} (at "
          f"{held['bfloat16']['layers']['worst']}); distance from "
          f"float32, card / CPU, mean and max: "
          + ", ".join(f"{k} {a:.4g} / {b:.4g} and {x:.4g} / {y:.4g}"
                      for k, (a, b, x, y) in
                      held['bfloat16']['from_f32'].items())
          + "; "
          f"posture through the CLI (object Tracker): "
          + "; ".join(
              f"{k} {v['predictions']} predictions, posture "
              f"{v['posture_s'] * 1e3:.2f} ms and adding "
              f"{v['adding_s'] * 1e3:.2f} ms a frame, midlines on "
              f"{v['midline_share'][0]:.3f} (min "
              f"{v['midline_share'][1]:.3f}) of a frame's fish, midline / "
              f"stamp length {v['length_ratio'][0]:.3f} "
              f"({v['length_ratio'][1]:.3f}-{v['length_ratio'][2]:.3f}), "
              f"{v['files']} files equal to the CPU run's"
              for k, v in post.items())
          + f"; no port kernel launched; phase {r['s']:.1f} s", flush=True)


SAM_FISH = 32              # box prompts, one per fish, at frame 0
SAM_FRAMES = 16
SAM_CUT_FRAMES = 8         # when the script reaches the phase late
SAM_LATE_S = 950.0
SAM_SEED = 17
SAM_ROW_TOL = 0.02         # tests/test_torch_sam.py ROW_TOL
SAM_BF16_RATIO = 1.25      # C8's rule: the card's bfloat16 distance from
                           # float32, mean over the values, against the CPU's
SAM_F32_TOL = 1e-3         # float32 card against CPU: the largest
                           # difference over the largest magnitude
SAM_MASK_MARGIN = 1e-3     # logits this close to mask_threshold may flip
SAM_SESSION = ((0, 1, 2, 3, 6), 5, 7)   # commits, invalidate_from, last


def sam_prompt(track, n=SAM_FISH, pad=2):
    """One box a fish, for every 8th of the scene's fish at frame 0,
    from the ground truth (:func:`synth_scene`'s stamps), in
    ``detect_sam3_prompt``'s string format."""
    boxes = []
    for k in range(0, 8 * n, 8):
        x, y = (int(v) for v in track[0, k])
        w, h = 13 + (k % 5), 8 + (k % 3)
        boxes.append([x - pad, y - pad, x + w + pad, y + h + pad])
    return "{0:[" + ",".join("[" + ",".join(str(v) for v in b) + "]"
                             for b in boxes) + "]}"


def write_sam_pth(root, seed=SAM_SEED):
    """A seeded random ViT-B in segment-anything's checkpoint layout (the
    port's ``official_state_dict``); returns its path and the port's
    state of the same weights."""
    import torch

    from trex_tpu_torch.models import sam as P

    model = P.build(dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(seed))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    path = root / "sam_vit_b.pth"
    torch.save(P.official_state_dict(state), path)
    return path, state


def sam_text_tower(seed=SAM_SEED + 1):
    """A seeded random text tower (its sizes do not depend on the
    encoder's), as the port's state entries ``text_encoder.*``."""
    import torch

    from trex_tpu_torch.models import sam as P

    m = P.build(img_size=64, encoder_dim=32, encoder_depth=1,
                encoder_heads=1, global_idx=(), dtype=torch.float32,
                with_text=True, device="cpu",
                generator=torch.Generator().manual_seed(seed))
    return {k: v.numpy() for k, v in m.state_dict().items()
            if k.startswith("text_encoder.")}


class SamCapture:
    """Keeps the inputs and outputs of a segmenter's ``encode`` and
    ``decode`` for one ``segment`` call and times them between CUDA
    events (on the card)."""

    def __init__(self, seg, keep=True):
        self.model, self.keep = seg.model, keep
        self.card = seg.device.type == "cuda"
        self.calls = {"encode": [], "decode": []}
        self.events = {"encode": [], "decode": []}

    def __enter__(self):
        import torch

        for name in self.calls:
            fn = getattr(self.model, name)

            def wrapped(*a, _fn=fn, _name=name):
                if self.card:
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                out = _fn(*a)
                if self.card:
                    e1.record()
                    self.events[_name].append((e0, e1))
                if self.keep:
                    self.calls[_name].append((a, out))
                return out

            setattr(self.model, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name in self.calls:
            delattr(self.model, name)

    def device_ms(self, name):
        import torch

        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events[name]]


def sam_full_logits(seg, img, masks, iou):
    """The logits ``segment`` thresholds, at the frame's size: the picked
    decoded mask of each prompt (``1 + argmax`` of the IoU past the
    first), resized as ``segment`` resizes them."""
    from trex_tpu_torch.track.tag_image import _resize_linear_f32

    masks, iou = masks.float().cpu().numpy(), iou.float().cpu().numpy()
    best = 1 + iou[:, 1:].argmax(1)
    low = masks[np.arange(len(masks)), best]
    H, W = img.shape[:2]
    size = seg.model.img_size
    scale = size / max(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    up = _resize_linear_f32(low, (size, size))[:, :nh, :nw]
    return _resize_linear_f32(up, (W, H))


def sam_rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def sam_held(path, card16, objs, img, dev):
    """The card against the port's CPU path on one frame.

    float32 on both (TF32 off): image embedding, mask logits and IoU
    within :data:`SAM_F32_TOL`; the masks' decisions equal but for
    pixels whose CPU logit lies within :data:`SAM_MASK_MARGIN` of the
    threshold, the blob counts equal and the pixel counts apart by no
    more than those pixels. bfloat16 (the backend's own segmenter on
    the card against a CPU one): each ViT block and the mask decoder,
    fed the CPU's input, within :data:`SAM_ROW_TOL`; the whole forward
    no further from the CPU's float32 values, on average, than
    :data:`SAM_BF16_RATIO` times the CPU's bfloat16 values are."""
    import torch

    from trex_tpu_torch.detect import sam3

    out = {}
    seg32 = {side: sam3.SamSegmenter.from_checkpoint(
        path, dtype=torch.float32, device=d)
        for side, d in (("card", dev), ("cpu", "cpu"))}
    got32 = {}
    for side, seg in seg32.items():
        t0 = time.perf_counter()
        with SamCapture(seg) as cap:
            masks = seg.segment(img, objs)
        got32[side] = (cap.calls, masks, time.perf_counter() - t0)
    (gc, gm, _), (cc, cm, cpu_s) = got32["card"], got32["cpu"]
    emb = sam_rel(gc["encode"][0][1], cc["encode"][0][1])
    mk = sam_rel(gc["decode"][0][1][0], cc["decode"][0][1][0])
    iou = sam_rel(gc["decode"][0][1][1], cc["decode"][0][1][1])
    check(max(emb, mk, iou) <= SAM_F32_TOL, f"sam: float32 card != CPU: "
          f"embedding {emb:.3g}, masks {mk:.3g}, iou {iou:.3g}")
    logits = sam_full_logits(seg32["cpu"], img, *cc["decode"][0][1])
    thr = seg32["cpu"].mask_threshold
    flips = near = 0
    blobs = {}
    for side, m in (("card", gm), ("cpu", cm)):
        blobs[side] = sam3.blobs_from_masks(m, img)
    for k, oid in enumerate(cm):
        check(np.array_equal(cm[oid], logits[k] > thr),
              "sam: the CPU logits do not give the CPU masks")
        clear = np.abs(logits[k] - thr) > SAM_MASK_MARGIN
        diff = gm[oid] != cm[oid]
        check(not diff[clear].any(), f"sam: object {oid}: "
              f"{int(diff[clear].sum())} pixels decided otherwise on the "
              f"card, beyond {SAM_MASK_MARGIN} of the threshold")
        flips += int(diff.sum())
        near += int((~clear).sum())
    npx = {s: sum(b.num_pixels for b in bl) for s, bl in blobs.items()}
    check(abs(len(blobs["card"]) - len(blobs["cpu"])) <= flips
          and abs(npx["card"] - npx["cpu"]) <= flips,
          f"sam: blobs card {len(blobs['card'])} / {npx['card']} px, CPU "
          f"{len(blobs['cpu'])} / {npx['cpu']} px, {flips} flips")
    out["float32"] = dict(embedding=emb, masks=mk, iou=iou, flips=flips,
                          near_threshold=near, blobs=len(blobs["cpu"]),
                          pixels=npx["cpu"], cpu_s=cpu_s)
    ref_emb, ref_masks = cc["encode"][0][1], cc["decode"][0][1][0]
    del seg32, got32, gc
    torch.cuda.empty_cache()

    # bfloat16: the CPU's forward with its blocks' inputs and outputs
    cpu16 = sam3.SamSegmenter.from_checkpoint(path, device="cpu")
    from trex_tpu_torch.models.sam import ViTBlock

    mods = dict(cpu16.model.named_modules())
    names = [n for n, m in mods.items() if isinstance(m, ViTBlock)] \
        + ["mask_decoder"]
    seen = {}
    hooks = [mods[n].register_forward_hook(
        lambda m, i, o, n=n: seen.__setitem__(n, (i, o))) for n in names]
    t0 = time.perf_counter()
    try:
        with SamCapture(cpu16) as c16:
            cpu16.segment(img, objs)
    finally:
        for h in hooks:
            h.remove()
    cpu16_s = time.perf_counter() - t0
    with SamCapture(card16) as g16:
        card16.segment(img, objs)
    card_mods = dict(card16.model.named_modules())
    worst, rel = "", 0.0
    with torch.no_grad():
        for n in names:
            args, want = seen.pop(n)
            got = card_mods[n](*(a.to(dev) for a in args))
            pairs = zip(got, want) if isinstance(want, tuple) \
                else [(got, want)]
            for g, w in pairs:
                r = sam_rel(g, w)
                if r > rel:
                    worst, rel = n, r
    check(rel <= SAM_ROW_TOL, f"sam: bfloat16 {worst}: card != CPU on the "
          f"same input, {rel:.4g} > {SAM_ROW_TOL}")
    from_f32 = {}
    for key, ref, g, c in (
            ("embedding", ref_emb, g16.calls["encode"][0][1],
             c16.calls["encode"][0][1]),
            ("masks", ref_masks, g16.calls["decode"][0][1][0],
             c16.calls["decode"][0][1][0])):
        ref = ref.float()
        dist = [float((x.float().cpu() - ref).abs().mean()) for x in (g, c)]
        from_f32[key] = dist
        check(dist[0] <= SAM_BF16_RATIO * dist[1], f"sam: bfloat16 {key}: "
              f"the card lies {dist[0]:.4g} from float32 on average, the "
              f"CPU {dist[1]:.4g}")
    out["bfloat16"] = dict(layers=len(names), max_rel=rel, worst=worst,
                           from_f32=from_f32, cpu_s=cpu16_s)
    return out


def sam_text_held(state, emb, dev):
    """``decode_text`` at full width: the checkpoint's decoder with a
    seeded random text tower, float32, the same embedding on the card
    and on the CPU, within :data:`SAM_F32_TOL`."""
    import torch

    from trex_tpu_torch.models import sam as P

    ids = torch.from_numpy(np.stack([P.tokenize_text(t) for t in (
        "fish", "a guppy", "zebrafish larva")]))
    got = {}
    for side, d in (("card", dev), ("cpu", "cpu")):
        m = P.build(dtype=torch.float32, with_text=True, state=state,
                    device=d)
        with torch.no_grad():
            got[side] = m.decode_text(emb.to(d), ids.to(d))
    masks = sam_rel(got["card"][0], got["cpu"][0])
    iou = sam_rel(got["card"][1], got["cpu"][1])
    check(max(masks, iou) <= SAM_F32_TOL and got["card"][0].shape
          == (3, 4, 256, 256), f"sam: decode_text card != CPU: masks "
          f"{masks:.3g}, iou {iou:.3g}")
    return dict(masks=masks, iou=iou)


class SamReplayBackend:
    """A ``Sam3ReplaySession`` backend: every call is logged; with a
    segmenter, ``predict`` segments the frame with the prompts active
    there and returns each object's pixel count."""

    def __init__(self, seg=None, frames=None, prompts=None):
        self.seg, self.frames, self.prompts = seg, frames, prompts
        self.calls = []

    def reset(self, frame):
        self.calls.append(("reset", frame))

    def predict(self, frame, n_new):
        self.calls.append(("predict", frame, n_new))
        if self.seg is None:
            return None
        masks = self.seg.segment(self.frames[frame],
                                 self.prompts.materialize(frame))
        return {oid: int(m.sum()) for oid, m in masks.items() if m.any()}

    def replay_begin(self, start, end, count):
        self.calls.append(("replay_begin", start, end, count))

    def replay_step(self, n):
        self.calls.append(("replay_step", n))

    def replay_finish(self):
        self.calls.append(("replay_finish",))


def sam_session(seg, frames, prompt, direct):
    """A ``Sam3ReplaySession`` over the frames with the card's
    segmenter: commits of :data:`SAM_SESSION`, a forward jump, an
    invalidation and a replay from the best anchor left. Its calls
    equal the same schedule's on the CPU (a backend that computes
    nothing: the scheduler is host code), and every result it commits
    or replays equals the card's direct ``apply`` of that frame."""
    from trex_tpu_torch.detect import sam3

    pmap = sam3.parse_prompt_map(prompt)
    runs = {}
    for side, backend in (
            ("card", SamReplayBackend(seg, frames,
                                      sam3.Sam3Prompts.from_setting(prompt))),
            ("cpu", SamReplayBackend())):
        session = sam3.Sam3ReplaySession(backend, lambda f: None)
        session.set_prompts(pmap)
        results = {}
        commits, invalidate, last = SAM_SESSION
        for f in commits:
            p = session.process_frame(f)
            check(session.commit_frame(p), f"sam: frame {f} did not commit")
            results[f] = p.result
        stale = session.process_frame(last)
        session.invalidate_from(invalidate)
        check(not session.commit_frame(stale),
              "sam: an invalidated frame committed")
        p = session.process_frame(last)
        check(session.commit_frame(p), f"sam: frame {last} did not commit")
        results[last] = p.result
        runs[side] = (backend.calls, results)
    check(runs["card"][0] == runs["cpu"][0],
          "sam: the replay session's calls differ between card and CPU")
    for f, r in runs["card"][1].items():
        check(r == direct[f], f"sam: the session's frame {f} != the "
              f"direct segmentation")
    return dict(calls=len(runs["card"][0]),
                predicts=sum(c[0] == "predict" for c in runs["card"][0]),
                frames=sorted(runs["card"][1]))


def phase_sam(dev, report, t_script=0.0):
    """Promptable segmentation (phase 17 of the module docstring)."""
    import shutil

    import torch

    import trex_tpu_torch.detect.sam3 as sam3
    import trex_tpu_torch.track.tag_image as tag_image
    from trex_tpu_torch import kernels
    from trex_tpu_torch.detect.base import Sam3Backend, create_detection

    root = REPO / "build" / "smoke_sam"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    kernels.reset_launches()
    late = t_script > SAM_LATE_S
    n_frames = SAM_CUT_FRAMES if late else SAM_FRAMES
    bg, frames, track = synth_scene(n_frames)
    prompt = sam_prompt(track)
    path, state = write_sam_pth(root)
    n_params = sum(int(np.prod(v.shape)) for v in state.values())

    t0 = time.perf_counter()
    backend = create_detection(registry(dict(
        detect_type="sam3", detect_model=str(path),
        detect_sam3_prompt=prompt)), device=dev)
    load_s = time.perf_counter() - t0
    seg = backend.segmenter
    check(isinstance(backend, Sam3Backend) and seg.model.dtype
          == torch.bfloat16 and next(seg.model.parameters()).device.type
          == "cuda" and len(backend.prompts.materialize(0)) == SAM_FISH,
          "sam: the backend did not build ViT-B in bfloat16 on the card "
          "with one object a prompt box")

    # (a) throughput through apply; host time of the resizes and blobs
    backend.apply(0, frames[0])  # cuDNN's and cuBLAS' first calls
    torch.cuda.reset_peak_memory_stats(dev)
    with Spy((tag_image, "resize_linear"), (tag_image, "_resize_linear_f32"),
             (sam3, "blobs_from_masks"), keep=False) as host, \
            SamCapture(seg, keep=False) as cap:
        sync()
        t0 = time.perf_counter()
        blobs = [backend.apply(i, img) for i, img in enumerate(frames)]
        sync()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    enc_ms, dec_ms = cap.device_ms("encode"), cap.device_ms("decode")
    ids = {o.id for o in backend.prompts.materialize(0)}
    for i, b in enumerate(blobs):
        check(b and all(x.prediction in ids for x in b) and all(
            x.num_pixels > 0 for x in b), f"sam: frame {i}: no blobs, or "
              f"blobs of no prompt")
    direct = {i: {} for i in range(n_frames)}
    for i, bl in enumerate(blobs):
        for x in bl:
            direct[i][x.prediction] = direct[i].get(x.prediction, 0) \
                + x.num_pixels
    run = dict(frames=n_frames, fps=n_frames / wall, wall_s=wall,
               encoder_ms=statistics.median(enc_ms),
               decoder_ms=statistics.median(dec_ms),
               host_ms={k: 1e3 * v / n_frames
                        for k, v in host.seconds.items()},
               blobs=sum(len(b) for b in blobs) / n_frames,
               peak_mem_gb=peak)
    check(len(enc_ms) == len(dec_ms) == n_frames,
          "sam: one encode and one decode a frame expected")

    # (b) card against the CPU, (c) decode_text, (d) replay session
    objs = backend.prompts.materialize(0)
    held = sam_held(path, seg, objs, frames[0], dev)
    with SamCapture(seg) as c:
        seg.segment(frames[0], objs)
    emb = c.calls["encode"][0][1][0].float()
    text = sam_text_held(dict(state, **sam_text_tower()), emb, dev)
    session = sam_session(seg, frames, prompt, {
        i: {oid: n for oid, n in direct[i].items()}
        for i in range(n_frames)})
    check(not any(kernels.launches.values()),
          "sam: a port kernel launched on a path that has none")
    r = dict(cell="sam-vitb-16x1024-32", params=n_params, cut=late,
             load_s=load_s, run=run, held=held, text=text, session=session,
             s=time.perf_counter() - t_phase)
    report["sam"] = r
    f32, b16 = held["float32"], held["bfloat16"]
    print(f"phase 17 ok: SAM ViT-B ({n_params / 1e6:.1f} M parameters, "
          f"random, bfloat16) through create_detection over {n_frames} "
          f"frames of {SIZE}^2 with {SAM_FISH} box prompts"
          + (f" (cut from {SAM_FRAMES}: the script was past "
             f"{SAM_LATE_S:.0f} s)" if late else "")
          + f": {run['fps']:.2f} frames/s, encoder {run['encoder_ms']:.2f} "
          f"ms and decoder {run['decoder_ms']:.2f} ms a frame on the card, "
          f"host {sum(run['host_ms'].values()):.1f} ms a frame ("
          + ", ".join(f"{k} {v:.1f}" for k, v in run["host_ms"].items())
          + f"), {run['blobs']:.1f} blobs a frame, peak "
          f"{peak:.2f} GB; card == CPU in float32: embedding {f32['embedding']:.3g}, "
          f"masks {f32['masks']:.3g}, iou {f32['iou']:.3g} (CPU "
          f"{f32['cpu_s']:.1f} s), {f32['flips']} pixels flipped of "
          f"{f32['near_threshold']} within {SAM_MASK_MARGIN} of the "
          f"threshold, {f32['blobs']} blobs, {f32['pixels']} px; bfloat16 "
          f"layers on the same input: max {b16['max_rel']:.4g} of "
          f"{b16['layers']} (at {b16['worst']}), distance from float32 card "
          f"/ CPU: " + ", ".join(f"{k} {a:.4g} / {b:.4g}" for k, (a, b) in
                                 b16["from_f32"].items())
          + f" (CPU {b16['cpu_s']:.1f} s); decode_text card == CPU "
          f"{text['masks']:.3g} / {text['iou']:.3g}; replay session "
          f"{session['calls']} calls, {session['predicts']} predictions "
          f"equal to the CPU schedule and the direct frames; no port "
          f"kernel launched; phase {r['s']:.1f} s", flush=True)
    del backend, seg
    torch.cuda.empty_cache()


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
    phase_vi(dev, report)
    phase_vi_train(dev, report)
    phase_vf(dev, report, *chunk[:2])
    phase_tags(dev, report)
    phase_yolo(dev, report, time.perf_counter() - t0)
    phase_sam(dev, report, time.perf_counter() - t0)
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
        "posture", "decay", "archive", "product", "object", "vi",
        "vi_train", "vf", "tags", "yolo", "sam", "build_s", "total_s")}))
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
