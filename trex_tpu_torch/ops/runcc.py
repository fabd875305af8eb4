"""Run-based connected components and blob statistics on the card.

Counterpart of ``trex_tpu/ops/runcc.py``: a batch of frames goes in,
compact fixed-capacity per-frame blob tables come out: detect-threshold
blobs, track-threshold children with their parent slot, RLE runs for
both, fused per-blob statistics and overflow flags. Every output table
equals the reference's, fill values included.

All functions here work on the whole (B, H, W) batch at once. Fixed
sizes are kept without host syncs: compaction is a cumsum rank plus a
scatter into a buffer with one trailing drop slot; segment min/max are
``scatter_reduce`` into buffers pre-filled with the identities the
reference's ``segment_min``/``segment_max`` give empty segments
(INT32_MAX / INT32_MIN). The run-graph label loop runs for the batch
until no frame changes; extra rounds on converged frames are no-ops
because the body's fixed point is stable.

Centroid sums are float32: exact while a blob's coordinate sum stays
below 2^24.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..device import resolve_device

I32_MAX = 2 ** 31 - 1
I32_MIN = -2 ** 31


def _compact(flag: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """Positions of the True entries of each row of (B, N) `flag`, in
    order, in a (B, size) int32 buffer padded with `fill` (the fixed-size
    ``nonzero(size=, fill_value=)`` of the reference)."""
    b, n = flag.shape
    rank = torch.cumsum(flag.to(torch.int32), 1, dtype=torch.int32) - 1
    slot = torch.where(flag & (rank < size), rank, size).long()
    out = torch.full((b, size + 1), fill, dtype=torch.int32,
                     device=flag.device)
    pos = torch.arange(n, dtype=torch.int32, device=flag.device)
    out.scatter_(1, slot, pos.expand(b, n))
    return out[:, :size]


def _seg(src: torch.Tensor, idx: torch.Tensor, n_seg: int, how: str
         ) -> torch.Tensor:
    """Per-row segment reduction of (B, N) `src` by (B, N) `idx` into
    (B, n_seg): 'sum', 'amin' or 'amax', empty segments holding the
    reference's identities (0, INT32_MAX, INT32_MIN)."""
    fill = {"sum": 0, "amin": I32_MAX, "amax": I32_MIN}[how]
    out = torch.full((src.shape[0], n_seg), fill, dtype=src.dtype,
                     device=src.device)
    if how == "sum":
        return out.scatter_add_(1, idx.long(), src)
    return out.scatter_reduce_(1, idx.long(), src, how)


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(t, 1, idx.long())


def _run_tables(mask: torch.Tensor, max_runs: int) -> dict:
    """Horizontal runs of a (B, H, W) bool mask.

    Returns run tables (B, max_runs): y, x0, x1 int32 (padded entries:
    y = -1, x0 = 0, x1 = -1); n_runs (B,); run_id_flat (B, H*W + 1) run
    index per pixel (max_runs for background and for runs past the cap,
    the trailing element a gather-safe sentinel); overflow (B,)."""
    b, h, w = mask.shape
    hw = h * w
    left = F.pad(mask[:, :, :-1], (1, 0))
    right = F.pad(mask[:, :, 1:], (0, 1))
    starts = (mask & ~left).reshape(b, hw)
    ends = (mask & ~right).reshape(b, hw)
    mflat = mask.reshape(b, hw)
    csum = torch.cumsum(starts.to(torch.int32), 1, dtype=torch.int32)
    n_runs = csum[:, -1]
    run_id = torch.where(mflat, csum - 1, max_runs)
    run_id = torch.clamp_max(run_id, max_runs)  # overflow runs collapse
    run_id_flat = F.pad(run_id, (0, 1), value=max_runs)
    start_idx = _compact(starts, max_runs, hw)
    end_idx = _compact(ends, max_runs, hw)
    valid = start_idx < hw
    y = torch.where(valid, start_idx // w, -1)
    x0 = torch.where(valid, start_idx % w, 0)
    x1 = torch.where(valid, end_idx % w, -1)
    return {
        "y": y, "x0": x0, "x1": x1,
        "n_runs": n_runs,
        "run_id_flat": run_id_flat,
        "overflow": n_runs > max_runs,
    }


def _label_runs(mask: torch.Tensor, runs: dict, max_runs: int,
                max_pixels: int):
    """Connected-component labels over the run graph (8-connectivity).

    Returns (labels (B, max_runs) int32, the minimum run index of each
    run's component; pixel dict for downstream segment ops; overflow
    (B,) bool)."""
    b, h, w = mask.shape
    hw = h * w
    dev = mask.device
    mflat = mask.reshape(b, hw)
    pix = _compact(mflat, max_pixels, hw)
    n_pix = mflat.sum(1, dtype=torch.int32)
    rid = runs["run_id_flat"]
    r_pix = _gather(rid, torch.clamp_max(pix, hw))  # max_runs for padding
    py = pix // w
    px = pix % w
    ups = []
    for dx in (-1, 0, 1):
        up = pix - w + dx
        ok = (py > 0) & (px + dx >= 0) & (px + dx < w) & (pix < hw)
        ups.append(torch.where(ok, _gather(rid, up.clamp(0, hw)),
                               max_runs))
    up_all = torch.cat(ups, 1)
    R = max_runs
    L = torch.arange(R + 1, dtype=torch.int32,
                     device=dev).expand(b, R + 1).contiguous()
    while True:
        lr = _gather(L, r_pix)
        cand = torch.minimum(torch.minimum(_gather(L, ups[0]),
                                           _gather(L, ups[1])),
                             _gather(L, ups[2]))
        # propagate the min over a run's upper neighbourhood down to it
        new = torch.minimum(L, _seg(cand, r_pix, R + 1, "amin"))
        # and each pixel's label up to its upper-neighbour runs
        new = torch.minimum(new, _seg(lr.repeat(1, 3), up_all, R + 1,
                                      "amin"))
        new[:, R] = R
        # pointer jumping (path halving)
        new = _gather(new, new)
        new = _gather(new, new)
        changed = bool((new != L).any())
        L = new
        if not changed:
            break
    pixels = {"idx": pix, "run": r_pix, "n": n_pix, "y": py, "x": px}
    return L[:, :R], pixels, n_pix > max_pixels


def _blob_stats(runs: dict, labels: torch.Tensor, max_runs: int,
                max_blobs: int):
    """Canonical labels -> blob slots (ascending label order) and
    per-blob statistics. Returns (stats dict, slot_of_run (B, max_runs)
    int32 in [0, max_blobs], max_blobs marking invalid/overflow runs)."""
    R = max_runs
    b = labels.shape[0]
    valid = runs["y"] >= 0
    can = torch.where(valid, labels, R)
    # sorted unique of `can` (values in [0, R]) via a presence table
    present = torch.zeros((b, R + 1), dtype=torch.bool, device=can.device)
    present.scatter_(1, can.long(), True)
    rank = torch.cumsum(present.to(torch.int32), 1, dtype=torch.int32) - 1
    uniq = _compact(present, max_blobs + 1, R)
    slot = torch.clamp_max(_gather(rank, can), max_blobs)
    n_blobs = (uniq[:, :max_blobs] < R).sum(1, dtype=torch.int32)
    nseg = max_blobs + 1
    length = torch.where(valid, runs["x1"] - runs["x0"] + 1, 0)
    flen = length.to(torch.float32)
    count = _seg(flen, slot, nseg, "sum")
    sum_x = _seg((runs["x0"] + runs["x1"]).to(torch.float32) * 0.5 * flen,
                 slot, nseg, "sum")
    sum_y = _seg(runs["y"].to(torch.float32) * flen, slot, nseg, "sum")
    big = 1 << 30
    x0 = _seg(torch.where(valid, runs["x0"], big), slot, nseg, "amin")
    y0 = _seg(torch.where(valid, runs["y"], big), slot, nseg, "amin")
    x1 = _seg(torch.where(valid, runs["x1"], -1), slot, nseg, "amax")
    y1 = _seg(torch.where(valid, runs["y"], -1), slot, nseg, "amax")
    n_lines = _seg(valid.to(torch.int32), slot, nseg, "sum")
    stats = {
        "count": count[:, :max_blobs],
        "sum_x": sum_x[:, :max_blobs],
        "sum_y": sum_y[:, :max_blobs],
        "x0": x0[:, :max_blobs], "y0": y0[:, :max_blobs],
        "x1": x1[:, :max_blobs], "y1": y1[:, :max_blobs],
        "n_lines": n_lines[:, :max_blobs],
        "first_run": uniq[:, :max_blobs],
        "n_blobs": n_blobs,
        "overflow": (uniq < R).sum(1) > max_blobs,
    }
    return stats, slot


def _detect(frames: torch.Tensor, background: torch.Tensor,
            detect_threshold: int, detect_absolute: bool,
            track_threshold: int, track_absolute: bool,
            max_runs: int, max_pixels: int, max_blobs: int,
            max_child_runs: int, max_children: int) -> dict:
    b, h, w = frames.shape
    hw = h * w
    f = frames.to(torch.int16)
    bg = background.to(torch.int16)[None]
    adiff = (f - bg).abs()
    sdiff = bg - f
    nz = frames != 0
    det = ((adiff if detect_absolute else sdiff) >= detect_threshold) & nz
    out = {}
    runs = _run_tables(det, max_runs)
    labels, pixels, pix_overflow = _label_runs(det, runs, max_runs,
                                               max_pixels)
    stats, slot = _blob_stats(runs, labels, max_runs, max_blobs)
    out["det"] = stats
    out["det_runs"] = {
        "y": runs["y"], "x0": runs["x0"], "x1": runs["x1"],
        "slot": torch.where(runs["y"] >= 0, slot, max_blobs),
    }
    out["overflow"] = runs["overflow"] | pix_overflow | stats["overflow"]

    if track_threshold > 0:
        tmask = ((adiff if track_absolute else sdiff)
                 >= track_threshold) & det
        # fused recount at track_threshold per detect blob, summed over
        # the compact detect pixel list
        tflat = F.pad(tmask.reshape(b, hw), (0, 1))
        tpix = _gather(tflat, torch.clamp_max(pixels["idx"], hw)) \
            .to(torch.float32)
        pslot = _gather(slot, torch.clamp_max(pixels["run"], max_runs - 1))
        pslot = torch.where(pixels["run"] >= max_runs, max_blobs, pslot)
        tc = _seg(tpix, pslot, max_blobs + 1, "sum")
        out["det"]["track_count"] = tc[:, :max_blobs]

        cruns = _run_tables(tmask, max_child_runs)
        clabels, _, c_pix_overflow = _label_runs(
            tmask, cruns, max_child_runs, max_pixels)
        cstats, cslot = _blob_stats(cruns, clabels, max_child_runs,
                                    max_children)
        # child -> parent: the detect run under the child's first run
        fr = torch.clamp_max(cstats["first_run"], max_child_runs - 1)
        first_start = torch.where(
            cstats["first_run"] < max_child_runs,
            _gather(cruns["y"], fr) * w + _gather(cruns["x0"], fr), hw)
        prun = _gather(runs["run_id_flat"], torch.clamp_max(first_start, hw))
        parent = _gather(slot, torch.clamp_max(prun, max_runs - 1))
        parent = torch.where(prun >= max_runs, max_blobs, parent)
        cstats["parent"] = parent
        # every child pixel passes track_threshold by construction
        cstats["track_count"] = cstats["count"]
        out["child"] = cstats
        out["child_runs"] = {
            "y": cruns["y"], "x0": cruns["x0"], "x1": cruns["x1"],
            "slot": torch.where(cruns["y"] >= 0, cslot, max_children),
        }
        out["overflow"] = (out["overflow"] | cruns["overflow"]
                           | c_pix_overflow | cstats["overflow"])
    return out


def detect_batch_runs(frames, background, detect_threshold: int,
                      detect_absolute: bool, track_threshold: int = 0,
                      track_absolute: bool = True,
                      max_runs: int = 4096, max_pixels: int = 65536,
                      max_blobs: int = 512, max_child_runs: int = 4096,
                      max_children: int = 512, device=None) -> dict:
    """Batched detection: frames (B, H, W) uint8 -> blob tables.

    Per frame: detect blobs (stats + runs), optional track-threshold
    children (stats + runs + parent slot), and overflow flags (any cap
    exceeded -> the host must fall back to the native labeler for that
    frame). Every table has the batch as its leading dimension."""
    dev = resolve_device(device)
    frames = torch.as_tensor(frames, device=dev)
    background = torch.as_tensor(background, device=dev)
    return _detect(frames, background, detect_threshold=detect_threshold,
                   detect_absolute=detect_absolute,
                   track_threshold=track_threshold,
                   track_absolute=track_absolute, max_runs=max_runs,
                   max_pixels=max_pixels, max_blobs=max_blobs,
                   max_child_runs=max_child_runs,
                   max_children=max_children)


def background_copies(background, devices) -> dict:
    """One copy of `background` on each of `devices`, by device."""
    return {dev: torch.as_tensor(background, device=dev)
            for dev in set(devices)}


def detect_batch_runs_sharded(frames, background, mesh, axis: str = "data",
                              **kwargs) -> dict:
    """Detection with the frame batch split over the mesh's `axis`:
    contiguous blocks of B / n frames, one a device along the axis, each
    through :func:`detect_batch_runs` on its device with its own copy of
    the background (`background` may be those copies already, a dict
    from device to tensor, :func:`background_copies`), every shard
    launched before any is copied back (``parallel.mesh.run_shards``);
    the per-frame tables are joined in the batch's order on the axis'
    first device, equal byte for byte to the unsharded call (every
    table is per frame, and the label loop's extra rounds leave
    converged frames as they are). No collectives: the counterpart of
    the JAX package's batch-sharded ``jit``. The batch must divide by
    the axis size, as a JAX sharding requires. `kwargs` are
    detect_batch_runs' threshold and capacity options."""
    from ..parallel.mesh import join_shards, run_shards

    devs = mesh.axis_devices(axis)
    n = len(devs)
    if frames.shape[0] % n:
        raise ValueError(f"a batch of {frames.shape[0]} frames does not "
                         f"split over {n} devices of axis {axis!r}")
    per = frames.shape[0] // n
    bgs = background if isinstance(background, dict) else \
        background_copies(background, devs)

    def shard(i, dev):
        return detect_batch_runs(torch.as_tensor(
            frames[i * per:(i + 1) * per], device=dev), bgs[dev],
            device=dev, **kwargs)
    return join_shards(run_shards(shard, devs), devs[0])
