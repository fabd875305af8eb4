"""Port parity: trex_tpu_torch.ops.cc_device / device_pipeline vs the JAX
package on the CPU (the JAX stripe labeler in Pallas interpret mode).
Labels and statistics must match bit for bit.

The CUDA kernel itself is tested in ``test_torch_ccl_kernel.py``."""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

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


def test_label_components_use_pallas_not_ported():
    with pytest.raises(NotImplementedError, match="not ported"):
        T.label_components(torch.zeros((4, 4), dtype=torch.uint8),
                           use_pallas=True)
