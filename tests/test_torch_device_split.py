"""Port parity: ``trex_tpu_torch.ops.device_split`` against the JAX
package's ``trex_tpu.ops.device_split`` on the CPU, on random scenes of
merged fish (``tests/test_device_split.py``'s kernel-level scenes).

Equal: expectation counts and the marginal flag exactly; split pieces
(counts, bounding boxes, centroid sums) exactly, including the marginal
flag: every value is an integer or a float32 sum of integers and
half-integers below 2^24. Where the flag is clear, both equal the host
engine's native split."""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from trex_tpu.ops import device_split as J
from trex_tpu.ops.labeling import label_blobs_raw, split_execute
from trex_tpu_torch.ops import device_split as T
from trex_tpu_torch.track.engine import FastTracker

from test_torch_engine import (as_dict, one_torch_thread,  # noqa: F401
                               settings)

FCAP, BCAP, RCAP = 32, 64, 4096
SPEC = dict(initial=21, absolute=False, cm_sqr=1.0, max_shrink=0.02,
            shrink_limit=0.01, ranges=((20.0, 800.0),), crop_h=96,
            crop_w=96, max_runs=256, max_pieces=8)


def stamp(img, x, y, w=12, h=7, depth=110):
    """A fish with a darker core, so that escalation separates pairs."""
    yy, xx = np.mgrid[0:h, 0:w]
    e = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
    st = np.where(e <= 1.0, (depth * (1.0 - e * 0.75)).astype(int), 0)
    region = img[y:y + h, x:x + w]
    lim = (200 - st[:region.shape[0], :region.shape[1]]).astype(np.uint8)
    np.minimum(region, lim, out=region)


def merge_scene(rng):
    """(background, image, labeler output, fish positions): clusters of
    overlapping graded fish in 256^2, fish positions near their
    stamps."""
    bg = np.full((256, 256), 200, np.uint8)
    img = bg.copy()
    pos = []
    for i in range(int(rng.integers(4, 14))):
        if pos and rng.random() < 0.6:
            bx, by = pos[rng.integers(len(pos))]
            x = int(np.clip(bx + rng.integers(-9, 10), 5, 235))
            y = int(np.clip(by + rng.integers(-5, 6), 5, 240))
        else:
            x, y = int(rng.integers(5, 235)), int(rng.integers(5, 240))
        pos.append((x, y))
        stamp(img, x, y, w=int(rng.integers(9, 15)),
              depth=int(rng.integers(70, 130)))
    raw = label_blobs_raw(img, bg, threshold=20, absolute=False,
                          track_threshold=20, track_absolute=False)
    fish = np.array([(x + 6 + rng.normal(0, 2), y + 3 + rng.normal(0, 2))
                     for x, y in pos])
    return bg, img, raw, fish


def _pad(a, n, fill=0, dtype=np.float32):
    out = np.full(n, fill, dtype)
    out[:len(a)] = a
    return out


def _row_lines(table, r):
    if table.objs[r] is not None:
        return np.asarray(table.objs[r].lines)
    return table.lines[table.line_lo[r]:table.line_hi[r]]


@pytest.fixture(scope="module")
def jax_expectation():
    return jax.jit(partial(J.expectation_counts, B=BCAP))


def test_expectation_counts_equals_jax(jax_expectation):
    eng = FastTracker(as_dict(settings(32, track_size_filter=[[5, 400]])),
                      np.full((256, 256), 200, np.uint8))
    rng = np.random.default_rng(0)
    checked = split = marginal = 0
    for trial in range(24):
        bg, img, raw, fish = merge_scene(rng)
        table, _ = eng.build_candidates(
            raw["lines"], raw["pixels"], raw["line_start"],
            raw["pixel_start"], raw["stats"])
        B = table.n
        runs = np.asarray([(y, x0, x1, r) for r in range(B)
                           for y, x0, x1 in _row_lines(table, r)],
                          np.int32).reshape(-1, 4)
        if not B or B > BCAP or len(runs) > RCAP or len(fish) > FCAP:
            continue
        F = len(fish)
        rp = np.zeros((RCAP, 4), np.int32)
        rp[:, 3] = BCAP
        rp[:len(runs)] = runs
        args = [_pad(fish[:, 0], FCAP), _pad(fish[:, 1], FCAP),
                _pad(np.ones(F, bool), FCAP, False, bool),
                rp[:, 0], rp[:, 1], rp[:, 2], rp[:, 3],
                _pad(table.bx0, BCAP), _pad(table.by0, BCAP),
                _pad(table.bx1, BCAP), _pad(table.by1, BCAP),
                _pad(np.ones(B, bool), BCAP, False, bool)]
        max_d = np.float32(300.0 / 25.0 * 0.5)
        e_ref, m_ref = jax_expectation(*map(jnp.asarray, args),
                                       jnp.float32(max_d))
        e_got, m_got = T.expectation_counts(
            *map(torch.as_tensor, args), torch.tensor(max_d), BCAP)
        np.testing.assert_array_equal(e_got.numpy(), np.asarray(e_ref))
        assert bool(m_got) == bool(m_ref), trial
        checked += 1
        marginal += bool(m_got)
        if not bool(m_got):
            host = eng._split_expectation(table, fish, float(max_d))
            assert {int(b): int(v) for b, v in
                    enumerate(e_got.numpy()[:B]) if v} == host
            split += any(v >= 2 for v in host.values())
    assert checked >= 20 and split >= 5 and marginal < checked


def _biggest_blob(raw):
    ls = raw["line_start"]
    sizes = [int(np.sum(raw["lines"][ls[b]:ls[b + 1], 2]
                        - raw["lines"][ls[b]:ls[b + 1], 1] + 1))
             for b in range(len(ls) - 1)]
    return int(np.argmax(sizes)), max(sizes)


def _split_inputs(rng):
    bg = np.full((160, 160), 200, np.uint8)
    img = bg.copy()
    for _ in range(int(rng.integers(2, 5))):
        stamp(img, int(np.clip(70 + rng.integers(-14, 15), 10, 135)),
              int(np.clip(70 + rng.integers(-10, 11), 10, 140)),
              w=int(rng.integers(9, 16)), h=int(rng.integers(6, 11)),
              depth=int(rng.integers(60, 140)))
    raw = label_blobs_raw(img, bg, threshold=20, absolute=False,
                          track_threshold=20, track_absolute=False)
    b, n = _biggest_blob(raw)
    ls, ps = raw["line_start"], raw["pixel_start"]
    L = np.ascontiguousarray(raw["lines"][ls[b]:ls[b + 1]], np.int32)
    PX = np.ascontiguousarray(raw["pixels"][ps[b]:ps[b + 1]], np.uint8)
    runs = np.zeros((512, 4), np.int32)
    runs[:, 3] = 1
    runs[:len(L), :3] = L
    runs[:len(L), 3] = 0
    return bg, img, L, PX, runs, n


def test_split_execute_device_equals_jax():
    spec_j = J.SplitSpec(**SPEC)
    spec_t = T.SplitSpec(**SPEC)
    jdev = jax.jit(partial(J.split_execute_device, spec=spec_j))
    rng = np.random.default_rng(1)
    checked = pieces = 0
    lanes = []
    for trial in range(30):
        bg, img, L, PX, runs, n = _split_inputs(rng)
        if n < 40:
            continue
        expected = int(rng.integers(2, 4))
        x0, y0 = int(L[:, 1].min()), int(L[:, 0].min())
        ref = jdev(jnp.asarray(img), jnp.asarray(bg), jnp.int32(0),
                   jnp.int32(x0), jnp.int32(y0), *map(jnp.asarray, runs.T),
                   jnp.int32(expected))
        got = T.split_execute_device(
            torch.as_tensor(img), torch.as_tensor(bg), 0, x0, y0,
            *map(torch.as_tensor, runs.T), expected, spec_t)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        checked += 1
        if not bool(got[2]):
            host = split_execute(L, PX, bg, 21, False, expected, 1.0, 0.02,
                                 0.01, [[20.0, 800.0]])
            k = int(got[1])
            assert k == len(host)
            np.testing.assert_array_equal(got[0][:k, :5].numpy(),
                                          host[:, :5].astype(np.float32))
            pieces += k > 0
        lanes.append((img, bg, x0, y0, runs, expected, got))
    assert checked >= 20 and pieces >= 5
    # lanes of one frame at once equal the one-target calls
    img, bg = lanes[0][0], lanes[0][1]
    sel = [ln for ln in lanes if ln[0] is img][:1] * 3
    rows, n_out, marg = T.split_execute_device(
        torch.as_tensor(img), torch.as_tensor(bg),
        torch.zeros(3, dtype=torch.int32),
        torch.tensor([s[2] for s in sel]), torch.tensor([s[3] for s in sel]),
        *map(torch.as_tensor, sel[0][4].T),
        torch.tensor([s[5] for s in sel]), spec_t)
    for i, s in enumerate(sel):
        np.testing.assert_array_equal(rows[i].numpy(), s[6][0].numpy())
        assert int(n_out[i]) == int(s[6][1])
        assert bool(marg[i]) == bool(s[6][2])


def test_spec_and_size_bounds_equal_jax():
    from trex_tpu.config import reset_global_settings

    s = reset_global_settings()
    d = as_dict(settings(4, track_size_filter=[[10, 45], [100, 400]],
                         cm_per_pixel=0.7))
    for k, v in d.items():
        s.set(k, v)
    assert tuple(T.spec_from_settings(d, max_splits=9)) \
        == tuple(J.spec_from_settings(s, max_splits=9))
    spec = T.spec_from_settings(d)
    assert T._size_bounds(spec) == J._size_bounds(J.SplitSpec(*spec))
    n = np.arange(0, 1000, dtype=np.int32)
    np.testing.assert_array_equal(
        T._in_any_range(torch.as_tensor(n), spec).numpy(),
        np.asarray(J._in_any_range(jnp.asarray(n), J.SplitSpec(*spec))))
