"""Port parity: the port's decay estimates over motion windows
(``trex_tpu_torch/track/cache_batch.py``) against the JAX package's
``window_motion`` / ``window_estimate_scalar`` on the windows of the JAX
package's own Individuals (``tests/test_cache_batch.py``'s scenes: random
walks with frame gaps).

Tolerance: none. Both are float64 numpy over the same inputs; every
output array and every scalar estimate is bit-equal."""
import numpy as np
import pytest

from trex_tpu.track import cache_batch as J
from trex_tpu_torch.config import DEFAULTS
from trex_tpu_torch.track import cache_batch as T

from test_cache_batch import _random_individuals


def _windows(decay, drop, seed):
    s, inds, frame_times = _random_individuals(decay=decay,
                                               drop_prob=drop, seed=seed)
    W4 = np.stack([ind._win for ind in inds])
    starts = np.array([ind.start_frame for ind in inds], np.int64)
    return s, {k: s[k] for k in DEFAULTS}, W4, starts, frame_times


@pytest.mark.parametrize("decay,drop,seed", [
    (0.7, 0.0, 3), (0.7, 0.2, 3), (1.0, 0.1, 3), (0.0, 0.0, 3),
    (0.4, 0.3, 5), (0.95, 0.15, 11)])
def test_window_motion_equals_jax(decay, drop, seed):
    s, d, W4, starts, frame_times = _windows(decay, drop, seed)
    frame, time = 25, 1.0
    ref = J.window_motion(W4, starts, frame, time, frame_times, s)
    got = T.window_motion(W4, starts, frame, time, frame_times, d)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if drop and decay < 1:
        # frame gaps before the estimate take the scalar walk
        assert got["need_scalar"].any()


@pytest.mark.parametrize("decay,drop,seed", [
    (0.7, 0.2, 3), (0.4, 0.3, 5), (0.7, 0.0, 7)])
def test_window_estimate_scalar_equals_jax(decay, drop, seed):
    s, d, W4, starts, frame_times = _windows(decay, drop, seed)
    # a stalled timeline (a step over 1 s) breaks the chains
    stalled = {f: t + (1.2 if f >= 20 else 0.0)
               for f, t in frame_times.items()}
    for times in (frame_times, stalled):
        for frame in (25, 27):
            for i in range(len(W4)):
                ref = J.window_estimate_scalar(W4[i], int(starts[i]), frame,
                                               frame / 25, times, s)
                got = T.window_estimate_scalar(W4[i], int(starts[i]), frame,
                                               frame / 25, times, d)
                assert got == ref, (i, frame)
