"""Port parity: the port's own build of ``native/tracker_core.cpp``
(``trex_tpu_torch/native/``, bound in ``trex_tpu_torch/ops/labeling.py``)
against the JAX package's library on the same arrays: the automatic
mode's caches, paired probabilities with per-clique matching (pending
edges included, and the overflow of their buffer) and reactivation.
Outputs are bit-equal: one source, the same flags."""
import ctypes

import numpy as np
import pytest

from trex_tpu.ops import labeling as jax_labeling
from trex_tpu_torch.ops import labeling

F64 = ctypes.POINTER(ctypes.c_double)
I64 = ctypes.POINTER(ctypes.c_int64)
I32 = ctypes.POINTER(ctypes.c_int32)


def _libs():
    return jax_labeling._lib(), labeling._lib()


def _p(a, t):
    return a.ctypes.data_as(t)


def _state(rng, F, frame):
    last_frame = np.where(rng.random(F) < 0.9,
                          frame - rng.integers(1, 30, F), -(10 ** 9))
    last_frame = last_frame.astype(np.int64)
    ring = np.sort(rng.integers(frame - 60, frame, (F, 16, 2)), 2)
    return dict(
        last_frame=last_frame,
        last_time=last_frame / 25.0 + rng.normal(0, 1e-3, F),
        trk_start=np.minimum(last_frame, frame - rng.integers(1, 40, F)),
        ring=np.ascontiguousarray(ring.astype(np.int64)),
        ring_n=rng.integers(0, 17, F).astype(np.int32),
        x=rng.uniform(0, 512, F), y=rng.uniform(0, 512, F))


@pytest.mark.parametrize("seed", range(4))
def test_track_caches_equal(seed):
    rng = np.random.default_rng(seed)
    F, frame = 96, 120
    st = _state(rng, F, frame)
    outs = []
    for lib in _libs():
        tdelta = np.empty(F)
        tprob = np.empty(F)
        lib.trex_track_caches(
            F, frame, frame / 25.0, 3, _p(st["last_frame"], I64),
            _p(st["last_time"], F64), _p(st["trk_start"], I64),
            _p(st["ring"], I64), _p(st["ring_n"], I32), 16, 25, 0.5, 0.1,
            5, 1, _p(tdelta, F64), _p(tprob, F64))
        outs.append((tdelta, tprob))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert (outs[1][1] > 0).any()


def _match(lib, uf, st, tdelta, tprob, bcx, bcy, cap):
    B = len(bcx)
    fob = np.empty(B, np.int32)
    pob = np.empty(B)
    pf = np.empty(max(cap, 1), np.int32)
    pb = np.empty(max(cap, 1), np.int32)
    pp = np.empty(max(cap, 1))
    n = lib.trex_track_match(
        _p(uf, I32), len(uf), _p(st["x"], F64), _p(st["y"], F64),
        _p(tdelta, F64), _p(tprob, F64), _p(bcx, F64), _p(bcy, F64), B,
        0.1, 1.0 / 300.0, 8, _p(fob, I32), _p(pob, F64), _p(pf, I32),
        _p(pb, I32), _p(pp, F64), cap)
    return n, fob, pob, pf[:max(n, 0)], pb[:max(n, 0)], pp[:max(n, 0)]


@pytest.mark.parametrize("seed", range(4))
def test_track_match_equal_with_pending_and_overflow(seed):
    """Clustered fish and blobs: singleton cliques, tree cliques and
    cliques of more than 8 fish (pending edges); a pending buffer of 4
    overflows (-1) in both libraries alike."""
    rng = np.random.default_rng(10 + seed)
    F = 64
    st = _state(rng, F, 50)
    # three crowds of 11 fish, the rest spread out with a blob each
    centres = np.repeat(rng.uniform(40, 470, (3, 2)), 11, 0)
    spread = rng.uniform(0, 512, (F - 33, 2))
    pos = np.concatenate([centres + rng.normal(0, 3, (33, 2)), spread])
    st["x"], st["y"] = pos[:, 0].copy(), pos[:, 1].copy()
    blobs = np.concatenate([centres + rng.normal(0, 3, (33, 2)),
                            spread + rng.normal(0, 2, spread.shape)])
    bcx, bcy = blobs[:, 0].copy(), blobs[:, 1].copy()
    uf = np.flatnonzero(rng.random(F) < 0.95).astype(np.int32)
    tdelta = np.full(F, 0.04)
    tprob = rng.uniform(0.3, 1.0, F)
    outs = [_match(lib, uf, st, tdelta, tprob, bcx, bcy, 65536)
            for lib in _libs()]
    assert outs[0][0] == outs[1][0] > 0       # pending edges exist
    for a, b in zip(outs[0][1:], outs[1][1:]):
        np.testing.assert_array_equal(a, b)
    assert (outs[1][1] >= 0).any()
    small = [_match(lib, uf, st, tdelta, tprob, bcx, bcy, 4)[0]
             for lib in _libs()]
    assert small == [-1, -1]


def test_track_reactivate_equal():
    rng = np.random.default_rng(3)
    F, B = 48, 40
    st = _state(rng, F, 80)
    cand = np.sort(rng.choice(F, 30, replace=False)).astype(np.int32)
    has = (rng.random(30) < 0.8).astype(np.uint8)
    tdelta = rng.uniform(0.5, 3.0, F)
    free = np.sort(rng.choice(B, 25, replace=False)).astype(np.int32)
    cx = rng.uniform(0, 512, B)
    cy = rng.uniform(0, 512, B)
    cx[free[0]], cy[free[0]] = st["x"][cand[0]], st["y"][cand[0]]
    outs = []
    for lib in _libs():
        fob = np.full(B, -1, np.int32)
        lib.trex_track_reactivate(
            _p(cand, I32), len(cand), has.ctypes.data_as(ctypes.c_char_p),
            _p(st["x"], F64), _p(st["y"], F64), _p(tdelta, F64),
            _p(free, I32), len(free), _p(cx, F64), _p(cy, F64), 0.1,
            _p(fob, I32))
        outs.append(fob)
    np.testing.assert_array_equal(outs[0], outs[1])
    assert (outs[1] >= 0).sum() == 25


def test_split_bindings_equal():
    """The expectation and the batched split executor, bound in the port
    for the first time, equal the JAX package's bindings."""
    import test_torch_device_split as S

    bg, img, raw, fish = S.merge_scene(np.random.default_rng(5))
    ls = raw["line_start"]
    bounds = np.stack([
        [raw["lines"][ls[i]:ls[i + 1], 1].min(),
         raw["lines"][ls[i], 0],
         raw["lines"][ls[i]:ls[i + 1], 2].max(),
         raw["lines"][ls[i + 1] - 1, 0]] for i in range(len(ls) - 1)
    ]).astype(np.float64)
    args = (fish, raw["lines"], ls[:-1], ls[1:], bounds, 6.0)
    want = jax_labeling.expectation_native(*args)
    np.testing.assert_array_equal(labeling.expectation_native(*args), want)
    assert want.max() >= 2
    jobs = np.flatnonzero(want >= 2)
    split = (raw["lines"], raw["pixels"], ls[jobs], ls[jobs + 1],
             raw["pixel_start"][jobs], want[jobs], 21, False, 1.0, 0.2,
             0.2)
    ref = jax_labeling.SplitExecutor(bg, [[10, 120]]).run_batch(*split)
    got = labeling.SplitExecutor(bg, [[10, 120]]).run_batch(*split)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    one = labeling.split_execute(
        raw["lines"][ls[jobs[0]]:ls[jobs[0] + 1]],
        raw["pixels"][raw["pixel_start"][jobs[0]]:
                      raw["pixel_start"][jobs[0] + 1]],
        bg, 21, False, int(want[jobs[0]]), 1.0, 0.2, 0.2, [[10, 120]])
    np.testing.assert_array_equal(one, got[0])
