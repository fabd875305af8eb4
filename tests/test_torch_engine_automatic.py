"""Port parity: the port's host FastTracker in the product-default
configuration (``match_mode=automatic`` with its native phases, history
splits on) against the JAX package's FastTracker on the CPU, frame by
frame, on 256^2 chunks of ``chip_smoke.synth_frames`` and on a merging
pair; ``hungarian`` and ``tree`` take the Python paths and the Python
split.

Tolerance: fish ids, tracklet bookkeeping and per-frame statistics
exactly equal; x, y and probabilities within 1e-6 (both engines compute
them in float64 from the same labeler output and the same native code,
so they agree to the last bit in practice)."""
import numpy as np
import pytest

from trex_tpu.ops.labeling import label_blobs_raw as jax_raw
from trex_tpu.track.engine import FastTracker as JaxFastTracker
from trex_tpu_torch.ops.labeling import label_blobs_raw
from trex_tpu_torch.track.engine import FastTracker

import chip_smoke
from test_torch_engine import (as_dict, assert_history_equal,  # noqa: F401
                               detect_kwargs, one_torch_thread, settings)

SCENES = {
    # name: (frames, n_fish, seed, size filter)
    "synth24": (24, 24, 0, [[20, 400]]),
    "synth32": (16, 32, 1, [[20, 400]]),
}


def _scene(name):
    if name == "merge":
        bg, frames = chip_smoke.auto_pair_frames("merge")
        return bg, frames, settings(2, match_mode="automatic",
                                    track_do_history_split=True,
                                    track_size_filter=[[10, 120]])
    n_frames, n_fish, seed, sf = SCENES[name]
    bg, frames = chip_smoke.synth_frames(n_frames, n_fish=n_fish, size=256,
                                         seed=seed)
    return bg, frames, settings(n_fish, match_mode="automatic",
                                track_do_history_split=True,
                                track_size_filter=sf)


def run_pair(name, mode="automatic", pending_cap=None):
    """Both engines over the scene; returns (reference, port, number of
    the port's batched native split calls)."""
    bg, frames, s = _scene(name)
    s.set("match_mode", mode)
    det = detect_kwargs(s)
    ref = JaxFastTracker(s, bg)
    got = FastTracker(as_dict(s), bg)
    if pending_cap is not None:
        # a pending-edge buffer this small overflows: the frame takes
        # the Python matching path
        got._pend_buf = (np.empty(pending_cap, np.int32),
                         np.empty(pending_cap, np.int32),
                         np.empty(pending_cap))
    batches = []
    orig = got._split_native_batch
    got._split_native_batch = lambda *a: batches.append(1) or orig(*a)
    for i, img in enumerate(frames):
        ref.add_frame(i, i / 25.0, **jax_raw(img, bg, **det))
        got.add_frame(i, i / 25.0, **label_blobs_raw(img, bg, **det))
    return ref, got, len(frames), len(batches)


def assert_engines_equal(ref, got, n):
    assert got.n_fish == ref.n_fish > 0
    assert_history_equal(ref, got, n)
    for k in ("last_frame", "last_x", "last_y", "n_basic", "trk_start",
              "prev_trk_end", "trk_ring", "trk_ring_n"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k),
                                      err_msg=k)
    assert got.closed_tracklets == ref.closed_tracklets
    for f in range(n):
        a, b = ref.statistics[f], got.statistics[f]
        assert (a.number_fish, a.match_improvements) \
            == (b.number_fish, b.match_improvements), f


@pytest.mark.parametrize("name", list(SCENES) + ["merge"])
def test_automatic_with_history_split_equals_jax(name):
    ref, got, n, batches = run_pair(name)
    assert got.use_native
    assert_engines_equal(ref, got, n)
    # some frame's history split went through the batched native call
    assert batches > 0


@pytest.mark.parametrize("mode", ["hungarian", "tree"])
def test_python_modes_with_history_split_equal_jax(mode):
    ref, got, n, batches = run_pair("synth24", mode)
    assert not got.use_native and batches == 0
    assert_engines_equal(ref, got, n)


def test_pending_edge_overflow_falls_back_to_python(monkeypatch):
    calls = []
    orig = FastTracker._match_py
    monkeypatch.setattr(FastTracker, "_match_py",
                        lambda self, *a: calls.append(1) or orig(self, *a))
    ref, got, n, _ = run_pair("synth32", pending_cap=1)
    assert_engines_equal(ref, got, n)
    assert len(calls) >= 3     # frames whose big cliques overflowed


def test_split_expectation_native_equals_numpy():
    """The native expectation and its numpy twin agree on the frames of
    the merging pair."""
    bg, frames, s = _scene("merge")
    eng = FastTracker(as_dict(s), bg)
    det = detect_kwargs(s)
    compared = 0
    for i, img in enumerate(frames):
        raw = label_blobs_raw(img, bg, **det)
        if i:
            table, _ = eng.build_candidates(
                raw["lines"], raw["pixels"], raw["line_start"],
                raw["pixel_start"], raw["stats"])
            pos = np.stack([eng.last_x[:eng.n_fish],
                            eng.last_y[:eng.n_fish]], 1)
            want = eng._split_expectation_py(table, pos, 6.0)
            assert eng._split_expectation(table, pos, 6.0) == want
            compared += bool(want)
        eng.add_frame(i, i / 25.0, **raw)
    assert compared > 10
