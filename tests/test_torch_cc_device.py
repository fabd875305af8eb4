"""Port parity: trex_tpu_torch.ops.cc_device / device_pipeline vs the JAX
package on the CPU (the JAX stripe labeler and neighbour-min kernel in
Pallas interpret mode). Labels, stencils and statistics must match bit
for bit.

The CUDA kernels themselves are tested in ``test_torch_ccl_kernel.py``."""
import functools

import numpy as np
import pytest

import chip_smoke
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from trex_tpu.ops import cc_device as J
from trex_tpu.ops.device_pipeline import detect_batch as jax_detect_batch
from trex_tpu_torch.ops import cc_device as T
from trex_tpu_torch.ops.device_pipeline import detect_batch

SHAPES = [(16, 16, None), (48, 64, 8), (40, 200, 16), (33, 130, 8)]


def _s_shape():
    m = np.zeros((64, 96), np.uint8)
    m[2, 2:90] = 1
    m[2:50, 89] = 1
    m[49, 4:90] = 1
    m[50:60, 4] = 1
    return m


def _jax_vmem(mask, stripe_h):
    return np.asarray(J.label_components_vmem(
        jnp.asarray(mask[None]), stripe_h=stripe_h, interpret=True))[0]


@pytest.mark.parametrize("H,W,sh", SHAPES)
@pytest.mark.parametrize("density", [0.1, 0.35, 0.6])
def test_labels_equal_jax_stripe_labeler(H, W, sh, density):
    rng = np.random.default_rng([H, W, int(density * 100)])
    mask = (rng.random((H, W)) < density).astype(np.uint8)
    ref = _jax_vmem(mask, sh)
    t = torch.as_tensor(mask)
    np.testing.assert_array_equal(T.label_components(t).numpy(), ref)
    np.testing.assert_array_equal(
        T.label_components_vmem(t[None]).numpy()[0], ref)


def test_labels_multi_stripe_s_shape_and_batch():
    m = _s_shape()
    ref = _jax_vmem(m, 8)
    np.testing.assert_array_equal(
        T.label_components_vmem(torch.as_tensor(m)[None]).numpy()[0], ref)
    np.testing.assert_array_equal(
        T.label_components(torch.as_tensor(m)).numpy(), ref)
    rng = np.random.default_rng(0)
    mb = (rng.random((3, 32, 96)) < 0.4).astype(np.uint8)
    ref = np.asarray(J.label_components_vmem(jnp.asarray(mb), stripe_h=8,
                                             interpret=True))
    np.testing.assert_array_equal(
        T.label_components_vmem(torch.as_tensor(mb)).numpy(), ref)
    np.testing.assert_array_equal(
        T.label_components(torch.as_tensor(mb)).numpy(), ref)


def test_component_stats_exact():
    rng = np.random.default_rng(4)
    mask = (rng.random((40, 56)) < 0.35).astype(np.uint8)
    labels = np.array(J.label_components(jnp.asarray(mask)))
    img = (rng.random((40, 56)) < 0.5).astype(np.uint8)
    for max_blobs in (8, 256):
        ref = J.component_stats(jnp.asarray(labels), jnp.asarray(img),
                                max_blobs=max_blobs)
        got = T.component_stats(torch.as_tensor(labels),
                                torch.as_tensor(img), max_blobs=max_blobs)
        for k in ref:
            r = np.asarray(ref[k])
            g = got[k].numpy()
            assert r.dtype == g.dtype, k
            np.testing.assert_array_equal(g, r, err_msg=k)


def _blob_frames(n, seed):
    rng = np.random.default_rng(seed)
    bg = np.full((64, 96), 200, np.uint8)
    frames = np.full((n, 64, 96), 200, np.uint8)
    for b in range(n):
        for _ in range(5):
            y, x = rng.integers(5, 55), rng.integers(5, 85)
            frames[b, y:y + 5, x:x + 8] = 90
    return bg, frames


@pytest.mark.parametrize("use_pallas", [True, False])
def test_detect_batch_equals_jax(use_pallas):
    bg, frames = _blob_frames(2, 7)
    kw = dict(threshold=20, track_threshold=40, absolute=False,
              max_blobs=64)
    ref = jax_detect_batch(jnp.asarray(frames), jnp.asarray(bg),
                           use_pallas=True, **kw)
    got = detect_batch(frames, bg, use_pallas=use_pallas, device="cpu", **kw)
    valid = np.asarray(ref["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for k in ("cx", "cy", "count", "track_count"):
        np.testing.assert_array_equal(
            np.where(valid, got[k].numpy(), 0),
            np.where(valid, np.asarray(ref[k]), 0), err_msg=k)


@jax.jit
def _pallas_neighbor_min(tile):
    """The TPU kernel B2 in Pallas interpret mode, as
    tests/test_cc_device.py runs it."""
    return pl.pallas_call(
        J._neighbor_min_kernel,
        out_shape=jax.ShapeDtypeStruct(tile.shape, jnp.int32),
        interpret=True)(tile)


@pytest.mark.parametrize("shape", [(8, 8), (3, 3), (19, 45), (34, 130)])
def test_neighbor_min_plain_equals_pallas_kernel(shape):
    """The whole tile, wrapped border included, bit for bit."""
    rng = np.random.default_rng(list(shape))
    tile = rng.integers(-2 ** 31, 2 ** 31 - 1, shape, dtype=np.int32)
    if shape == (34, 130):
        # a padded label tile as the labeler builds it
        tile = np.pad(rng.integers(0, 33 * 128, (32, 128),
                                   dtype=np.int32), 1,
                      constant_values=J._INACT)
    ref = np.asarray(_pallas_neighbor_min(jnp.asarray(tile)))
    got = T.neighbor_min(torch.as_tensor(tile)[None])
    np.testing.assert_array_equal(got[0].numpy(), ref)
    # a batch wraps each frame in itself, never into its neighbour
    batch = np.stack([tile, tile[::-1].copy()])
    got = T.neighbor_min(torch.as_tensor(batch)).numpy()
    np.testing.assert_array_equal(got[0], ref)
    np.testing.assert_array_equal(
        got[1], np.asarray(_pallas_neighbor_min(jnp.asarray(batch[1]))))


_row_run_min = jax.jit(J._row_run_min)


def _pallas_loop(mask):
    """label_components(use_pallas=True)'s loop (cc_device.py:106-119)
    built from the JAX package's own _row_run_min and the Pallas kernel
    in interpret mode (the JAX path itself needs a TPU)."""
    fg = jnp.asarray(mask) > 0
    h, w = fg.shape
    labels = jnp.where(fg, jnp.arange(h * w, dtype=jnp.int32)
                       .reshape(h, w), J.INACTIVE)
    while True:
        run = _row_run_min(labels, fg)
        padded = jnp.pad(run, 1, constant_values=J.INACTIVE)
        nm = _pallas_neighbor_min(padded)[1:-1, 1:-1]
        new = jnp.where(fg, jnp.minimum(run, nm), J.INACTIVE)
        changed = bool(jnp.any(new != labels))
        labels = new
        if not changed:
            return np.asarray(jnp.where(fg, labels, -1))


@pytest.mark.parametrize("case", ["random", "s_shape", "batch"])
def test_label_components_use_pallas_equals_jax(case):
    rng = np.random.default_rng(11)
    if case == "random":
        masks = (rng.random((1, 40, 70)) < 0.45).astype(np.uint8)
    elif case == "s_shape":
        masks = _s_shape()[None]
    else:
        masks = (rng.random((3, 24, 50)) < 0.35).astype(np.uint8)
    got = T.label_components(torch.as_tensor(masks), use_pallas=True)
    assert got.dtype == torch.int32
    for b, m in enumerate(masks):
        ref = np.asarray(J.label_components(jnp.asarray(m)))
        np.testing.assert_array_equal(got[b].numpy(), ref)
        np.testing.assert_array_equal(got[b].numpy(), _pallas_loop(m))
    if case == "s_shape":
        np.testing.assert_array_equal(
            T.label_components(torch.as_tensor(masks[0]),
                               use_pallas=True).numpy(), got[0].numpy())


_HARD_MASKS = dict(chip_smoke.hard_masks())
_HARD_TILES = {name: t for name, t, _ in chip_smoke.hard_tiles()}


@functools.lru_cache(maxsize=None)
def _jax_hard_labels():
    """The JAX package's labels of every mask of chip_smoke.hard_masks():
    {name: (label_components_vmem in interpret mode, label_components)}.

    Masks of one height are padded with background to one width and
    labelled as one batch (one compilation per height, not per width),
    and the labels y * Wp + x mapped back to y * W + x. Background
    columns on the right change no component and no component's first
    pixel; label_components_vmem pads every width to a multiple of 128
    itself. Each entry is (B, H, W), as the mask."""
    by_h = {}
    for name, m in _HARD_MASKS.items():
        by_h.setdefault(m.shape[1], []).append(name)
    out = {}
    for names in by_h.values():
        wp = max(_HARD_MASKS[n].shape[2] for n in names)
        batch = np.concatenate([
            np.pad(_HARD_MASKS[n], ((0, 0), (0, 0),
                                    (0, wp - _HARD_MASKS[n].shape[2])))
            for n in names]).astype(np.uint8)
        vmem = np.asarray(J.label_components_vmem(jnp.asarray(batch),
                                                  interpret=True))
        prop = np.stack([np.asarray(J.label_components(jnp.asarray(m)))
                         for m in batch])
        start = 0
        for n in names:
            b, _, w = _HARD_MASKS[n].shape
            out[n] = tuple(np.where(lab[:, :, :w] >= 0,
                                    lab[:, :, :w] // wp * w
                                    + lab[:, :, :w] % wp, -1)
                           for lab in (vmem[start:start + b],
                                       prop[start:start + b]))
            start += b
    return out


@pytest.fixture()
def one_thread():
    """These masks take the propagation labeler hundreds of steps of small
    operations; one intra-op thread keeps them fast when the test
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(_HARD_MASKS))
def test_hard_masks_equal_jax(name, one_thread):
    """chip_smoke.py's masks that break tiled labellers (diagonal-only
    components, corner staircases, full and empty frames, H = 1, W = 1,
    every width mod 16, frames of one tile): the port's plain union-find
    and propagation labeler give the JAX package's labels, bit for bit."""
    vmem, prop = _jax_hard_labels()[name]
    np.testing.assert_array_equal(vmem, prop)
    mask = torch.as_tensor(_HARD_MASKS[name])
    np.testing.assert_array_equal(T.label_components_plain(mask).numpy(),
                                  vmem)
    np.testing.assert_array_equal(T.label_components(mask).numpy(), vmem)


@pytest.mark.parametrize("name", list(_HARD_TILES))
def test_hard_tiles_plain_equals_pallas_kernel(name):
    """chip_smoke.py's tiles for the stencil's vector widths and strips:
    the plain stencil equals the Pallas B2 in interpret mode, frame by
    frame, wrapped border included."""
    tiles = _HARD_TILES[name]
    got = T.neighbor_min_plain(torch.as_tensor(tiles)).numpy()
    for g, tile in zip(got, tiles):
        np.testing.assert_array_equal(
            g, np.asarray(_pallas_neighbor_min(jnp.asarray(tile))))
