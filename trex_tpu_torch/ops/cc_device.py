"""Device connected components (PyTorch + CUDA).

Counterpart of ``trex_tpu/ops/cc_device.py``. Labels are linear indices
``y * W + x`` of each component's first pixel in scan order (8-connected),
background ``-1``: the same canonical representative as the host labeler.

- :func:`label_components`: min-label propagation (run minimum plus
  3x3 neighbour minimum until nothing changes). With ``use_pallas=True``
  each step's stencil is :func:`neighbor_min`, which on a CUDA tensor
  launches the hand-written kernel ``csrc/neighbor_min.cu`` (it replaces
  the TPU's neighbour-min kernel); on a CPU tensor it runs
  :func:`neighbor_min_plain`.
- :func:`label_components_vmem`: the batched labeler. On a CUDA tensor
  it launches the hand-written union-find kernel ``csrc/ccl.cu``, which
  replaces the TPU's VMEM stripe relaxation; on a CPU tensor it runs
  :func:`label_components_plain`, which gives identical labels.
- :func:`component_stats`: per-component count and x, y, value sums as
  a float32 segment reduction (exact below 2^24, never TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels

INACTIVE = 2 ** 30
_I32_MAX = 2 ** 31 - 1
# rows of one block of csrc/neighbor_min.cu (kStripRows * kWarps) and of
# one tile of csrc/ccl.cu (kTileH): the launch grid's y extent is the
# height over these, and must stay within 65535
_NM_BLOCK_ROWS = 8 * 4
_CCL_TILE_ROWS = 32


def _row_run_min(labels: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Min label over each horizontal run of foreground pixels (the
    forward and backward segmented min-scans of the reference combined),
    INACTIVE on background. labels, fg: (N, H, W)."""
    n, h, w = fg.shape
    left = F.pad(fg[:, :, :-1], (1, 0))
    start = fg & ~left
    run = torch.cumsum(start.reshape(n, -1).to(torch.int32), 1,
                       dtype=torch.int32) - 1
    n_seg = h * w + 1
    seg = torch.where(fg.reshape(n, -1), run, h * w).long()
    mins = torch.full((n, n_seg), _I32_MAX, dtype=torch.int32,
                      device=fg.device)
    mins.scatter_reduce_(1, seg, labels.reshape(n, -1), "amin")
    out = torch.gather(mins, 1, seg).reshape(n, h, w)
    return torch.where(fg, out, INACTIVE)


def neighbor_min_plain(tiles: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``csrc/neighbor_min.cu``: the minimum of
    the 3x3 window around each element of (N, H, W) tiles, centre
    included, indices modulo each tile's own H and W (``jnp.roll``'s
    wrap in the TPU kernel, never across frames)."""
    m = tiles
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = torch.minimum(m, torch.roll(tiles, (dy, dx), (1, 2)))
    return m


def neighbor_min(tiles: torch.Tensor) -> torch.Tensor:
    """3x3 wrapped minimum of (N, H, W) int32 tiles, the same shape out.

    On a CUDA tensor this launches ``csrc/neighbor_min.cu`` once for the
    whole batch (it replaces the TPU kernel ``_neighbor_min_kernel``); on
    a CPU tensor it runs :func:`neighbor_min_plain`."""
    if tiles.dim() != 3 or tiles.dtype != torch.int32:
        raise ValueError("tiles must be (N, H, W) int32, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    if tiles.device.type == "cpu":
        return neighbor_min_plain(tiles)
    if tiles.device.type != "cuda":
        raise ValueError(f"unsupported device {tiles.device}")
    n, h, w = tiles.shape
    if h * w >= 2 ** 31 or n > 65535 or -(-h // _NM_BLOCK_ROWS) > 65535:
        raise ValueError(f"tiles {tuple(tiles.shape)} exceed the kernel's "
                         "int32 indices or its launch grid")
    src = tiles.contiguous()
    out = torch.empty_like(src)
    lib = kernels.library("neighbor_min")
    err = lib.trex_neighbor_min(
        src.data_ptr(), out.data_ptr(), n, h, w,
        torch.cuda.current_stream(tiles.device).cuda_stream)
    kernels.check(err, "trex_neighbor_min")
    kernels.launches["neighbor_min"] += 1
    return out


def label_components(mask: torch.Tensor, use_pallas: bool = False
                     ) -> torch.Tensor:
    """8-connected labels of a (H, W) mask, or of each frame of a
    (B, H, W) batch: int32, background -1, each component the linear
    index of its first pixel in scan order.

    ``use_pallas=True`` takes each step's neighbour minimum from
    :func:`neighbor_min` (the CUDA kernel on a CUDA tensor, one launch
    per step for the whole batch); otherwise from its plain version."""
    stencil = neighbor_min if use_pallas else neighbor_min_plain
    fg = mask > 0
    single = fg.dim() == 2
    if single:
        fg = fg[None]
    n, h, w = fg.shape
    lin = torch.arange(h * w, dtype=torch.int32,
                       device=fg.device).reshape(1, h, w)
    labels = torch.where(fg, lin, INACTIVE)
    while True:
        run = _row_run_min(labels, fg)
        padded = F.pad(run, (1, 1, 1, 1), value=INACTIVE)
        nm = stencil(padded)[:, 1:-1, 1:-1]
        new = torch.where(fg, torch.minimum(run, nm), INACTIVE)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    out = torch.where(fg, labels, -1)
    return out[0] if single else out


def label_components_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the CUDA kernel: union-find over the
    8-neighbour edge list, vectorised. Each round hooks every edge's
    endpoint root-candidates to the smaller label (scatter amin, the
    kernel's atomicMin link) and then compresses by pointer jumping
    (the kernel's compress pass), until nothing changes. Labels only
    decrease and always name a pixel of the same component at or before
    the pixel, so the fixed point is each component's minimum index.

    mask: (B, H, W). Returns (B, H, W) int32."""
    fg = mask > 0
    b, h, w = fg.shape
    hw = h * w
    n = b * hw
    dev = fg.device
    sentinel = n  # background points at a self-looping sentinel
    flat = fg.reshape(-1)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    lab = torch.cat([torch.where(flat, idx, sentinel),
                     torch.full((1,), sentinel, dtype=torch.int64,
                                device=dev)])
    ys = (idx % hw) // w
    xs = idx % w
    src, dst = [], []
    # W, NW, N, NE neighbours (each undirected edge once)
    for dy, dx in ((0, -1), (-1, -1), (-1, 0), (-1, 1)):
        ok = flat & (ys + dy >= 0) & (xs + dx >= 0) & (xs + dx < w)
        q = idx + dy * w + dx
        ok = ok & flat[q.clamp(0, n - 1)]
        src.append(idx[ok])
        dst.append(q[ok])
    p = torch.cat(src + dst)
    q = torch.cat(dst + src)
    while True:
        new = lab.clone()
        new.scatter_reduce_(0, new[p], lab[q], "amin")
        while True:
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, lab):
            break
        lab = new
    out = lab[:n] - (idx - idx % hw)
    return torch.where(flat, out, -1).to(torch.int32).reshape(b, h, w)


def label_components_vmem(mask: torch.Tensor) -> torch.Tensor:
    """Batched 8-connected labelling, mask (B, H, W) -> (B, H, W) int32:
    background -1, each component the linear index (y * W + x) of its
    first pixel in scan order.

    On a CUDA tensor this launches the union-find kernel of
    ``csrc/ccl.cu`` (which replaces the TPU stripe kernel); on a CPU
    tensor it runs :func:`label_components_plain`."""
    if mask.dim() != 3:
        raise ValueError(f"mask must be (B, H, W), got {tuple(mask.shape)}")
    if mask.device.type == "cpu":
        return label_components_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"unsupported device {mask.device}")
    b, h, w = mask.shape
    if h * w >= 2 ** 31 or b > 65535 or -(-h // _CCL_TILE_ROWS) > 65535:
        raise ValueError(f"mask {tuple(mask.shape)} exceeds the kernel's "
                         "int32 labels or its launch grid")
    # a bool tensor is already one 0/1 byte per pixel
    m = mask.contiguous().view(torch.uint8) if mask.dtype == torch.bool \
        else (mask > 0).to(torch.uint8)
    labels = torch.empty((b, h, w), dtype=torch.int32, device=mask.device)
    lib = kernels.library("ccl")
    # per-tile bookkeeping between the kernel's passes; the kernel fills it
    scratch = torch.empty(lib.trex_ccl_scratch_ints(b, h, w),
                          dtype=torch.int32, device=mask.device)
    err = lib.trex_ccl_label(
        m.data_ptr(), labels.data_ptr(), scratch.data_ptr(), b, h, w,
        torch.cuda.current_stream(mask.device).cuda_stream)
    kernels.check(err, "trex_ccl_label")
    kernels.launches["ccl"] += 1
    return labels


def component_stats(labels: torch.Tensor, image: torch.Tensor,
                    max_blobs: int = 256) -> dict:
    """Fixed-capacity per-component statistics from canonical labels.

    labels: (H, W) or (B, H, W) first-pixel linear indices (-1 for
    background), image: same shape. Slot k holds the k-th component in
    scan order of its first pixel. Returns 'ids' (canonical label or -1),
    'count', 'sum_x', 'sum_y', 'sum_value', each (..., max_blobs).

    The sums are float32 ``index_add_`` segment reductions: counts and
    integer coordinate sums stay exact below 2^24."""
    single = labels.dim() == 2
    if single:
        labels, image = labels[None], image[None]
    b, h, w = labels.shape
    dev = labels.device
    n = h * w
    flat = labels.reshape(b, n)
    vals = image.reshape(b, n).to(torch.float32)
    fg = flat >= 0
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    # a pixel is its component's representative iff its label equals its
    # own position; slots are the cumsum rank of representatives
    rep = flat == pos
    rank = torch.cumsum(rep.to(torch.int32), 1, dtype=torch.int32) - 1
    rep_slot = torch.where(rep, torch.clamp_max(rank, max_blobs), max_blobs)
    n_seg = max_blobs + 1
    ids = torch.full((b, n_seg), INACTIVE, dtype=torch.int32, device=dev)
    ids.scatter_(1, rep_slot.long(), pos.expand(b, n))
    ids[:, max_blobs] = INACTIVE
    seg = torch.where(
        fg, torch.gather(rep_slot, 1, flat.clamp(0, n - 1).long()),
        max_blobs)
    ones = torch.where(fg, 1.0, 0.0)
    xs = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    ys = torch.arange(h, dtype=torch.float32,
                      device=dev).repeat_interleave(w)
    feats = torch.stack([ones, xs * ones, ys * ones, vals * ones], 2)
    gseg = (seg + torch.arange(b, dtype=torch.int32, device=dev)[:, None]
            * n_seg).reshape(-1)
    sums = torch.zeros((b * n_seg, 4), dtype=torch.float32, device=dev)
    sums.index_add_(0, gseg, feats.reshape(-1, 4))
    sums = sums.reshape(b, n_seg, 4)
    count, sum_x, sum_y, sum_v = sums.unbind(2)
    valid = (ids >= 0) & (ids < INACTIVE) & (count > 0)
    out = {
        "ids": torch.where(valid, ids, -1)[:, :max_blobs],
        "count": torch.where(valid, count, 0.0)[:, :max_blobs],
        "sum_x": torch.where(valid, sum_x, 0.0)[:, :max_blobs],
        "sum_y": torch.where(valid, sum_y, 0.0)[:, :max_blobs],
        "sum_value": torch.where(valid, sum_v, 0.0)[:, :max_blobs],
    }
    if single:
        out = {k: v[0] for k, v in out.items()}
    return out
