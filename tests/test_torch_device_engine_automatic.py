"""Port parity in the product-default tracking configuration: the port's
DeviceTracker and scan entry points (``device="cpu"``) against the JAX
package's on the CPU, with ``match_mode=automatic`` (and ``hungarian``
as one case) and history splits on.

Equal: assist frames, ``needs_host`` flags, fish rows and split-child
flags exactly; per-frame positions bit for bit on committed device
frames and within 1e-6 on replayed ones (the rule of
``test_torch_device_engine.py``); n_fish and demotion. The packed
results are held to the rtol of ``test_torch_device_tracker.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from trex_tpu.config import reset_global_settings
from trex_tpu.ops import device_tracker as J
from trex_tpu.ops.labeling import label_blobs as jax_label_blobs
from trex_tpu.ops.runcc import detect_batch_runs as jax_runs
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.device_engine import DeviceTracker as JaxDeviceTracker
from trex_tpu_torch.ops import device_tracker as T
from trex_tpu_torch.ops.labeling import label_blobs
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.device_engine import DeviceTracker

import chip_smoke
from test_torch_device_engine import _feed, compare_engines
from test_torch_device_tracker import RTOL
from test_torch_engine import (SCENES, as_dict, detect_kwargs,  # noqa: F401
                               one_torch_thread)

CAPS = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
            max_child_runs=1024, max_children=64)


def _settings(n_fish, mode="automatic", size_filter=(20, 400)):
    s = reset_global_settings()
    d = dict(chip_smoke.track_settings(n_fish), match_mode=mode,
             track_do_history_split=True,
             track_size_filter=[list(size_filter)])
    for k, v in d.items():
        s.set(k, v)
    return s


def _stamp(img, x, y, w=12, h=7, depth=110):
    """tests/test_device_split.py's graded blob: a darker core, so that
    threshold escalation separates overlapping pairs."""
    yy, xx = np.mgrid[0:h, 0:w]
    e = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
    st = np.where(e <= 1.0, (depth * (1.0 - e * 0.75)).astype(int), 0)
    region = img[y:y + h, x:x + w]
    lim = (200 - st[:region.shape[0], :region.shape[1]]).astype(np.uint8)
    np.minimum(region, lim, out=region)


def crossing_frames(n_frames=40, hold=6):
    """Two graded fish of different shape and depth that merge into one
    blob (for 15 frames at `hold` 6, 3 at `hold` 1) and part again."""
    frames = []
    for f in range(n_frames):
        dx = max(0, abs(n_frames // 2 - f) - hold)
        img = np.full((256, 256), 200, np.uint8)
        _stamp(img, 121 - dx, 100)
        _stamp(img, 129 + dx, 102, w=13, depth=100)
        frames.append(img)
    return np.full((256, 256), 200, np.uint8), np.stack(frames)


def scene(name):
    """(background, frames, JAX settings, chunk)."""
    if name.startswith("crossing"):
        bg, frames = crossing_frames(hold=1 if name == "crossing_brief"
                                     else 6)
        return bg, frames, _settings(2, size_filter=(10, 120)), 40
    if name == "separated":
        frames, s, chunk = SCENES["separated"]()
        s.set("match_mode", "automatic")
        s.set("track_do_history_split", True)
        return np.full((256, 256), 200, np.uint8), np.stack(frames), s, \
            chunk
    mode = "hungarian" if name == "synth_hungarian" else "automatic"
    bg, frames = chip_smoke.synth_frames(24, n_fish=24, size=256, seed=1)
    return bg, frames, _settings(24, mode), 12


class _Runs:
    """Each package's result of one path on one scene, computed once per
    module."""

    def __init__(self):
        self._done = {}

    def get(self, kind, name):
        key = (kind, name)
        if key not in self._done:
            bg, frames, s, chunk = scene(name)
            d = as_dict(s)
            if kind == "fused":
                pair = (JaxDeviceTracker(s, bg, chunk=chunk)
                        .track_frames(frames),
                        DeviceTracker(d, bg, chunk=chunk, device="cpu")
                        .track_frames(frames))
            elif kind == "blobs":
                det = detect_kwargs(s)
                pair = (_feed(JaxDeviceTracker(s, bg, chunk=chunk),
                              jax_label_blobs, JaxTrackBlob, frames, bg,
                              det),
                        _feed(DeviceTracker(d, bg, chunk=chunk,
                                            device="cpu"),
                              label_blobs, TrackBlob, frames, bg, det))
            else:
                pair = (jax.device_get(J.track_video_device(
                    frames, bg, s, **CAPS)),
                    T.track_video_device(frames, bg, d, device="cpu",
                                         **CAPS))
            self._done[key] = (len(frames), pair)
        return self._done[key]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("name", ["synth", "crossing"])
def test_track_frames_equals_jax(runs, name):
    n, (ref, got) = runs.get("fused", name)
    compare_engines(ref, got, n)
    assert got.split_spec is not None
    if name == "crossing":
        # the merged pair splits on the card: one frame of 40 replayed
        assert len(got.assist_frames) == 1 and got.n_fish == 2
    else:
        assert got.assist_frames


@pytest.mark.parametrize("name", ["separated", "crossing_brief"])
def test_blob_path_equals_jax(runs, name):
    n, (ref, got) = runs.get("blobs", name)
    compare_engines(ref, got, n)
    if name == "crossing_brief":
        # no pixels on the card: the contested trigger replays the
        # merged frames
        assert got.assist_frames


@pytest.mark.parametrize("name", ["synth", "crossing", "synth_hungarian"])
def test_track_video_device_equals_jax(runs, name):
    _, (ref, got) = runs.get("scan", name)
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "n_fish", "detect_overflow", "fish_x",
              "fish_y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["fish_prob"].numpy(),
                               np.asarray(ref["fish_prob"]), rtol=RTOL,
                               atol=0)
    if name == "crossing":
        # split pieces were assigned in every merged frame
        assert int(got["fish_child"].any(1).sum()) == 15


def test_split_stats_count_targets():
    """The scan's per-frame stats: split targets and auction rounds."""
    bg, frames, s, _ = scene("crossing")
    stats = []
    hist = T.track_video_device(frames, bg, as_dict(s), device="cpu",
                                stats=stats, **CAPS)
    assert len(stats) == len(frames)
    n_split = [int(st["n_split"]) for st in stats]
    assert max(n_split) == 1 and sum(n_split) == 15 == int(
        hist["fish_child"].any(1).sum())
    assert all(int(st["rounds"]) >= 0 and not st["cap_hit"]
               for st in stats)


def test_packed_paths_with_run_tables_resume_across_packages():
    """scan_packed with trailing run tables equals the JAX scan_packed;
    and the fused path with the split spec resumes in the port from the
    JAX package's carry row, equal to the JAX package's own second half."""
    bg, frames, s, _ = scene("synth")
    d = as_dict(s)
    P = J.params_from_settings(s)
    Pt = T.params_from_settings(d)
    assert tuple(Pt) == tuple(P)
    kw = J._detect_kwargs(s, CAPS)
    n = len(frames)
    times = np.arange(n, dtype=np.float32) / np.float32(25.0)
    carry0 = J.carry_to_vec(J._init_carry(P, 0, 0.0))
    aux0 = J.make_aux(carry0, times, np.arange(n))

    # host-built tables with run tables (the blob path's layout)
    out = jax.device_get(jax_runs(jnp.asarray(frames), jnp.asarray(bg),
                                  **kw))
    det = J.detections_from_runcc(out, P)
    B = det["cx"].shape[1]
    R = det["runs_y"].shape[1]
    det_packed = np.concatenate(
        [np.asarray(det[k], np.float32) for k in
         ("cx", "cy", "bcx", "bcy", "recount", "valid", "runs_y",
          "runs_x0", "runs_x1", "runs_slot")], axis=1)
    ref = np.asarray(J.launch_resilient(
        J.scan_packed, jnp.asarray(det_packed), jnp.asarray(aux0), P, B, R))
    got = T.scan_packed(det_packed, aux0, Pt, B, R, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)
    h_ref, _ = J.unpack_result(ref, n, P)
    h_got, _ = T.unpack_result(got, n, Pt)
    np.testing.assert_array_equal(h_got["needs_host"], h_ref["needs_host"])
    assert h_ref["needs_host"].any()   # the contested trigger fired

    # fused with the split spec, resumed from the JAX carry at frame 12
    spec = J.default_split_spec(s, P)
    spec_t = T.default_split_spec(d, Pt)
    assert tuple(spec_t) == tuple(spec)
    half = n // 2
    first = np.asarray(J.launch_resilient(
        J.fused_scan_packed, jnp.asarray(frames[:half]), jnp.asarray(bg),
        jnp.asarray(J.make_aux(carry0, times[:half], np.arange(half))), P,
        split_spec=spec, **kw))
    _, rows = J.unpack_result(first, half, P)
    aux1 = J.make_aux(rows[-1], times[half:], np.arange(half, n))
    ref2 = np.asarray(J.launch_resilient(
        J.fused_scan_packed, jnp.asarray(frames[half:]), jnp.asarray(bg),
        jnp.asarray(aux1), P, split_spec=spec, **kw))
    got2 = T.fused_scan_packed(frames[half:], bg, aux1, Pt,
                               split_spec=spec_t, device="cpu", **kw)
    np.testing.assert_allclose(got2.numpy(), ref2, rtol=RTOL, atol=0)
    h_ref2, _ = J.unpack_result(ref2, n - half, P)
    h_got2, _ = T.unpack_result(got2, n - half, Pt)
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "fish_x", "fish_y"):
        np.testing.assert_array_equal(h_got2[k], h_ref2[k], err_msg=k)
    assert h_got2["fish_child"].any()    # pieces were assigned


@pytest.mark.parametrize("key,value,slice_name", [
    ("posture_closing_steps", 1, "posture-closing"),
])
def test_decay_and_posture_still_raise_naming_their_slice(key, value,
                                                          slice_name):
    """Posture itself runs now; its closing steps (which the JAX package
    keeps off its fast engines too) raise, naming their slice."""
    d = as_dict(_settings(2))
    d["calculate_posture"] = True
    d[key] = value
    frames = np.full((1, 32, 32), 200, np.uint8)
    from trex_tpu_torch.track.engine import EngineUnsupported
    with pytest.raises(EngineUnsupported, match=slice_name):
        DeviceTracker(d, frames[0], device="cpu")


def test_speed_decay_with_split_caps_equals_jax():
    """The product default with track_speed_decay 0.8, once refused, and
    non-default split capacities (split_caps): the crossing through
    track_video_device and DeviceTracker.track_frames, equal to the JAX
    package's."""
    from test_torch_decay import compare_engines as compare_decay

    bg, frames, s, chunk = scene("crossing")
    s.set("track_speed_decay", 0.8)
    d = as_dict(s)
    caps = dict(max_splits=2, max_pieces=3)
    assert T.default_split_spec(d, split_caps=caps) \
        == T.default_split_spec(d)._replace(**caps)
    assert tuple(T.default_split_spec(d, split_caps=caps)) == tuple(
        J.default_split_spec(s, split_caps=caps))
    ref = jax.device_get(J.track_video_device(frames, bg, s,
                                              split_caps=caps, **CAPS))
    got = T.track_video_device(frames, bg, d, device="cpu",
                               split_caps=caps, **CAPS)
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "n_fish", "fish_x", "fish_y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(got["fish_child"].any(1).sum()) > 0
    ref = JaxDeviceTracker(s, bg, chunk=chunk, split_caps=caps) \
        .track_frames(frames)
    got = DeviceTracker(d, bg, chunk=chunk, split_caps=caps,
                        device="cpu").track_frames(frames)
    assert got.split_spec.max_splits == 2
    compare_decay(ref, got, len(frames))
