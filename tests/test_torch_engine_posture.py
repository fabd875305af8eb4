"""Port parity: the port's host FastTracker with ``calculate_posture`` on
against the JAX package's FastTracker on the CPU.

Both engines run the same native batch chain (``native/posture_chain.cpp``
and the port's byte-equal copy) on the same labeler output, so their
``posture_history`` must be exactly equal, frame by frame, as must the
tracking history."""
import numpy as np
import pytest

from test_device_posture import _asym_frames, _posture_settings
from trex_tpu.ops.labeling import label_blobs_raw as jax_label_blobs_raw
from trex_tpu.track.engine import FastTracker as JaxFastTracker
from trex_tpu_torch.ops.labeling import label_blobs_raw
from trex_tpu_torch.track.engine import FastTracker

from test_torch_engine import as_dict, one_torch_thread  # noqa: F401


def _run(cls, label, s, frames, bg):
    det = dict(threshold=int(s["detect_threshold"]), absolute=False,
               track_threshold=int(s["track_threshold"]),
               track_absolute=False)
    tr = cls(s, bg)
    for i, fr in enumerate(frames):
        tr.add_frame(i, i / 25.0, **label(fr, bg, **det))
    return tr


def assert_posture_equal(ref, got, n_frames):
    assert sorted(got.posture_history) == sorted(ref.posture_history)
    for f in range(n_frames):
        a = ref.posture_history.get(f)
        b = got.posture_history.get(f)
        if a is None:
            continue
        for k in ("fish", "ok", "midline_length", "angle"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{f} {k}")
    np.testing.assert_array_equal(got._posture_dir, ref._posture_dir)


@pytest.mark.parametrize("mode", ["approximate", "automatic"])
def test_posture_history_equals_jax(mode):
    n = 4
    bg, frames = _asym_frames(n, 30)
    s = _posture_settings(n)
    s.set("match_mode", mode)
    ref = _run(JaxFastTracker, jax_label_blobs_raw, s, frames, bg)
    got = _run(FastTracker, label_blobs_raw, as_dict(s), frames, bg)
    assert sum(int(np.sum(h["ok"])) for h in ref.posture_history.values()) \
        > 0
    assert_posture_equal(ref, got, len(frames))
    for f in range(len(frames)):
        for k in ("fish", "x", "y", "prob"):
            np.testing.assert_array_equal(got.history[f][k],
                                          ref.history[f][k])


def test_posture_defaults_run():
    """The port's defaults have posture on: the engine takes them."""
    n = 2
    bg, frames = _asym_frames(n, 6, seed=5)
    d = as_dict(_posture_settings(n))
    for k in ("track_posture_threshold", "outline_resample"):
        del d[k]   # the port's own defaults
    tr = _run(FastTracker, label_blobs_raw, d, frames, bg)
    assert tr.do_posture and tr.posture_history
