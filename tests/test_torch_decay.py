"""Port parity under ``track_speed_decay < 1``: the port's decay estimate
in the scan (``_decay_estimates``), its scan entry points, its
DeviceTracker on both ingestion paths and its host FastTracker against
the JAX package's on the CPU, in the base configuration (approximate
matching) and the product default (automatic with history splits).

Tolerance.
- ``_decay_estimates``: the broken-window flag ``need_host`` is equal.
  The float32 estimates are not bit-equal: the JAX package's CPU program
  contracts multiplies and adds into fused multiply-adds and rewrites
  divisions (``x / sqrt(y)`` as ``x * rsqrt(y)``), where the port runs
  one rounded operation at a time, the same on the card and the CPU.
  The estimates are held to the error bound the scan itself keeps,
  |est_port - est_jax| <= est_err (the first-order bound of the float32
  estimate against the host's float64 one, which widens the deferral
  bands), and est_err to a relative 1e-3.
- Scan entry points and engines: every integer output, flag and history
  entry is equal (``test_torch_device_engine.py``'s rule: fish ids
  exact, positions within 1e-6), the probabilities of committed card
  frames within 1e-5 (they are float32 functions of the estimate); the
  packed carry's tracking section within rtol 2e-6, its decay window bit
  for bit and its accumulated walk within the err column it carries.
- FastTracker: the history equal within 1e-6 (float64 on both sides)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trex_tpu.ops import device_tracker as J
from trex_tpu.ops.labeling import label_blobs as jax_label_blobs
from trex_tpu.ops.labeling import label_blobs_raw as jax_label_blobs_raw
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.device_engine import DeviceTracker as JaxDeviceTracker
from trex_tpu.track.device_engine import _rebuild_dacc as jax_rebuild_dacc
from trex_tpu.track.engine import FastTracker as JaxFastTracker
from trex_tpu_torch.ops import device_tracker as T
from trex_tpu_torch.ops.labeling import label_blobs, label_blobs_raw
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.device_engine import DeviceTracker, _rebuild_dacc
from trex_tpu_torch.track.engine import FastTracker

import chip_smoke
from test_torch_device_engine import _feed
from test_torch_device_tracker import RTOL
from test_torch_engine import (as_dict, assert_history_equal,  # noqa: F401
                               detect_kwargs, one_torch_thread, render,
                               settings)

CAPS = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
            max_child_runs=1024, max_children=64)
DECAY = 0.7


# ----------------------------------------------------- _decay_estimates

def _windows(F, seed):
    """Random (F, 7, 5) motion windows: frame gaps, jittered and broken
    timelines (global steps of 0, over 1 s or negative), over-speed pairs,
    windows of repeated pairs, empty slots; and a non-zero dacc."""
    rng = np.random.default_rng(seed)
    W = T.DECAY_WIN
    win = np.zeros((F, W, 5), np.float32)
    win[:, :, 0] = -1e9
    for i in range(F):
        n = int(rng.integers(0, W + 1))
        f = int(rng.integers(10, 200))
        fr = []
        for _ in range(n):
            fr.append(f)
            f -= 1 + int(rng.random() < 0.15) * int(rng.integers(1, 4))
        x, y = rng.uniform(5, 900, 2)
        vx, vy = rng.normal(0, rng.choice([0.5, 3.0, 40.0]), 2)
        for k, ff in enumerate(fr[::-1]):
            x += vx * rng.uniform(0.5, 1.5)
            y += vy * rng.uniform(0.5, 1.5)
            t = ff / 25.0 + (rng.random() < 0.1) * rng.normal(0, 0.01)
            step = 0.04 if rng.random() > 0.05 \
                else rng.choice([0.0, 2.0, -0.01])
            win[i, W - n + k] = (ff, x, y, t, step)
    for i in range(0, F, 9):
        # identical consecutive pairs (the bound's cancelling terms)
        win[i, :, 0] = 30 + np.arange(W)
        win[i, :, 1] = 100 + 2.0 * np.arange(W)
        win[i, :, 2] = 50.0
        win[i, :, 3] = ((30 + np.arange(W)) / 25.0).astype(np.float32)
        win[i, :, 4] = np.float32(0.04)
    dacc = rng.normal(0, 1, (F, 3)).astype(np.float32)
    dacc[:, 2] = np.abs(dacc[:, 2]) * 1e-5
    dacc[rng.random(F) < 0.5] = 0
    return win, dacc


@pytest.mark.parametrize("max_speed,cm,seed", [
    (300.0, 1.0, 0), (300.0, 1.0, 1), (20.0, 0.1, 2), (0.0, 1.0, 3)])
def test_decay_estimates_within_the_bound_of_jax(max_speed, cm, seed):
    P = J.TrackParams(max_fish=1, p_min=0.1, cm_per_pixel=cm,
                      max_speed=max_speed, t_max=0.5, frame_rate=25,
                      time_prob_enabled=True, minimum_frames=5,
                      size_min=0.0, size_max=1e9, do_decay=True,
                      decay_lambda=DECAY ** 4)
    win, dacc = _windows(600, seed)
    ref = jax.jit(lambda w, d: J._decay_estimates(w, 0, P, d))(
        jnp.asarray(win), jnp.asarray(dacc))
    got = T._decay_estimates(torch.tensor(win), T.TrackParams(*P),
                             torch.tensor(dacc))
    rx, ry, rbad, rerr = (np.asarray(a) for a in ref[:4])
    gx, gy, gbad, gerr = (a.numpy() for a in got[:4])
    np.testing.assert_array_equal(gbad, rbad)
    assert rbad.any() and not rbad.all()
    np.testing.assert_allclose(gerr, rerr, rtol=1e-3, atol=0)
    np.testing.assert_array_less(np.abs(gx - rx), rerr + 1e-30)
    np.testing.assert_array_less(np.abs(gy - ry), rerr + 1e-30)
    np.testing.assert_array_equal(got[4]["counts"].numpy(),
                                  np.asarray(ref[4]["counts"]))


def test_sum_lr_is_left_to_right():
    v = np.float32([1e8, 1.0, -1e8, 1.0])
    lr = ((np.float32(0) + v[0] + v[1]) + v[2]) + v[3]
    assert float(T._sum_lr(torch.tensor(v[None]))[0]) == float(lr) == 1.0


# ------------------------------------------------------------- scenes

def _jax_settings(n, mode):
    s = settings(n, track_speed_decay=DECAY)
    if mode == "auto":
        s.set("match_mode", "automatic")
        s.set("track_do_history_split", True)
    return s


def scene_walk():
    """tests/test_device_engine.py:300: six fish on random walks."""
    rng = np.random.default_rng(7)
    pos = rng.uniform(20, 200, (6, 2))
    vel = rng.normal(0, 2.0, (6, 2))
    frames = []
    for _ in range(40):
        frames.append(render(pos))
        vel = np.clip(vel + rng.normal(0, 0.5, vel.shape), -4, 4)
        pos = np.clip(pos + vel, 10, 230)
    return np.full((256, 256), 200, np.uint8), np.stack(frames), 6, 16


def scene_gap():
    """tests/test_device_engine.py:322: fish 1 vanishes for four frames;
    its estimate walks the gap through the carry's accumulated dacc."""
    base = np.array([[40.0, 60.0], [120.0, 60.0], [200.0, 120.0]])
    frames = []
    for i in range(30):
        p = base + np.array([i * 1.5, 0.0])
        frames.append(render([p[k] for k in range(3)
                              if not (k == 1 and 10 <= i < 14)]))
    return np.full((256, 256), 200, np.uint8), np.stack(frames), 3, 10


def scene_synth():
    """chip_smoke's synthetic scene, 24 fish in 256^2: crossings flag
    frames for the replay."""
    bg, frames = chip_smoke.synth_frames(24, n_fish=24, size=256, seed=1)
    return bg, frames, 24, 12


SCENES = {"walk": scene_walk, "gap": scene_gap, "synth": scene_synth}


class _Runs:
    """Each package's result of one path on one scene and configuration,
    computed once per module."""

    def __init__(self):
        self._done = {}

    def get(self, kind, name, mode):
        key = (kind, name, mode)
        if key not in self._done:
            bg, frames, n, chunk = SCENES[name]()
            s = _jax_settings(n, mode)
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
            elif kind == "host":
                det = detect_kwargs(s)
                ref = JaxFastTracker(s, bg)
                got = FastTracker(d, bg)
                for i, img in enumerate(frames):
                    ref.add_frame(i, i / 25.0,
                                  **jax_label_blobs_raw(img, bg, **det))
                    got.add_frame(i, i / 25.0,
                                  **label_blobs_raw(img, bg, **det))
                pair = (ref, got)
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


def assert_history_close(ref, got, n_frames):
    """test_torch_engine.assert_history_equal with the probabilities held
    to 1e-5."""
    assert sorted(got.history) == sorted(ref.history)
    for f in range(n_frames):
        hr, hg = ref.history[f], got.history[f]
        np.testing.assert_array_equal(hg["fish"], hr["fish"], err_msg=f)
        for k, tol in (("x", 1e-6), ("y", 1e-6), ("prob", 1e-5)):
            np.testing.assert_allclose(hg[k], hr[k], rtol=0, atol=tol,
                                       err_msg=f"{f} {k}")


def compare_engines(ref, got, n_frames):
    """test_torch_device_engine.compare_engines with the probabilities
    of committed card frames held to 1e-5."""
    assert got.assist_frames == ref.assist_frames
    assert got.n_fish == ref.n_fish
    assert got.demoted == ref.demoted
    assert sorted(got.history) == list(range(n_frames))
    assert_history_close(ref, got, n_frames)
    assert [got.statistics[f].number_fish for f in range(n_frames)] \
        == [ref.statistics[f].number_fish for f in range(n_frames)]


def _compare_carry(got, ref, P):
    """Packed carry rows: the tracking section within RTOL, the motion
    window bit for bit, the accumulated walk within its err column."""
    got = np.asarray(got, np.float64).reshape(-1, T.carry_vec_size(P))
    ref = np.asarray(ref, np.float64).reshape(got.shape)
    F = P.max_fish
    base = T._track_vec_size(P) - (5 * T.DECAY_WIN + 3) * F
    np.testing.assert_allclose(got[:, :base], ref[:, :base], rtol=RTOL,
                               atol=0)
    w = base + 5 * T.DECAY_WIN * F
    np.testing.assert_array_equal(got[:, base:w], ref[:, base:w])
    dg = got[:, w:w + 3 * F].reshape(-1, F, 3)
    dr = ref[:, w:w + 3 * F].reshape(-1, F, 3)
    assert (np.abs(dg[..., :2] - dr[..., :2])
            <= dr[..., 2:] + 1e-30).all()


@pytest.mark.parametrize("mode", ["base", "auto"])
@pytest.mark.parametrize("name", ["walk", "gap", "synth"])
def test_track_video_device_equals_jax(runs, name, mode):
    _, (ref, got) = runs.get("scan", name, mode)
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "n_fish", "detect_overflow", "fish_x",
              "fish_y"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["fish_prob"].numpy(),
                               np.asarray(ref["fish_prob"]), rtol=RTOL,
                               atol=0)
    bg, frames, n, _ = SCENES[name]()
    P = T.params_from_settings(as_dict(_jax_settings(n, mode)))
    assert P.do_decay
    _compare_carry(got["carry_vec"].numpy(), ref["carry_vec"], P)
    if name == "gap":
        # the gap fish's walk accumulated while it was away
        F = P.max_fish
        w = T._track_vec_size(P) - 3 * F
        dacc = got["carry_vec"].numpy()[:, w:w + 3 * F].reshape(-1, F, 3)
        assert np.abs(dacc[10:14, 1, 0]).max() > 0


@pytest.mark.parametrize("name,mode", [
    ("walk", "base"), ("walk", "auto"), ("gap", "base"), ("gap", "auto"),
    ("synth", "base")])
def test_track_frames_equals_jax(runs, name, mode):
    n, (ref, got) = runs.get("fused", name, mode)
    compare_engines(ref, got, n)
    if name == "synth":
        assert got.assist_frames
    if name == "gap":
        # the gap is walked on the card, not replayed
        assert len(got.assist_frames) <= 2


@pytest.mark.parametrize("mode", ["base", "auto"])
@pytest.mark.parametrize("name", ["walk", "synth"])
def test_blob_path_equals_jax(runs, name, mode):
    n, (ref, got) = runs.get("blobs", name, mode)
    compare_engines(ref, got, n)


def test_fused_scan_packed_equals_jax():
    """fused_scan_packed with decay and the product default: the packed
    results within RTOL and the integer fields equal; resumed from the
    JAX package's carry row halfway."""
    bg, frames, n, _ = scene_synth()
    s = _jax_settings(n, "auto")
    P = J.params_from_settings(s)
    Pt = T.params_from_settings(as_dict(s))
    kw = dict(J._detect_kwargs(s, CAPS))
    spec = J.default_split_spec(s, P)
    spec_t = T.default_split_spec(as_dict(s), Pt)
    times = np.arange(len(frames)) / 25.0
    carry = J.carry_to_vec(jax.device_get(J._init_carry(P, 0, 0.0)))
    aux = J.make_aux(carry, times, np.arange(len(frames)))
    ref = np.asarray(J.launch_resilient(
        J.fused_scan_packed, jnp.asarray(frames), jnp.asarray(bg),
        jnp.asarray(aux), P, split_spec=spec, **kw))
    got = T.fused_scan_packed(frames, bg, aux, Pt, split_spec=spec_t,
                              device="cpu", **kw).numpy()
    T_ = len(frames)
    h_ref, rows_ref = J.unpack_result(ref, T_, P)
    h_got, rows_got = T.unpack_result(got, T_, Pt)
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "fish_x", "fish_y"):
        np.testing.assert_array_equal(h_got[k], h_ref[k], err_msg=k)
    assert h_got["needs_host"].any()
    _compare_carry(rows_got, rows_ref, Pt)
    # resume from the JAX package's carry row at the middle of the chunk
    half = T_ // 2
    aux1 = J.make_aux(rows_ref[half - 1], times[half:], np.arange(half, T_))
    ref1 = np.asarray(J.launch_resilient(
        J.fused_scan_packed, jnp.asarray(frames[half:]), jnp.asarray(bg),
        jnp.asarray(aux1), P, split_spec=spec, **kw))
    got1 = T.fused_scan_packed(frames[half:], bg, aux1, Pt,
                               split_spec=spec_t, device="cpu", **kw)
    h1_ref, _ = J.unpack_result(ref1, T_ - half, P)
    h1_got, _ = T.unpack_result(got1, T_ - half, Pt)
    for k in ("fish_row", "fish_seen", "needs_host", "n_assigned"):
        np.testing.assert_array_equal(h1_got[k], h1_ref[k], err_msg=k)


@pytest.mark.parametrize("mode", ["base", "auto"])
@pytest.mark.parametrize("name", ["walk", "synth"])
def test_fast_tracker_equals_jax(runs, name, mode):
    n, (ref, got) = runs.get("host", name, mode)
    assert got.decay_active and ref.decay_active
    assert_history_equal(ref, got, n)
    np.testing.assert_array_equal(got.win, ref.win)
    np.testing.assert_array_equal(got.start_frame_f, ref.start_frame_f)


def test_fast_tracker_nonuniform_timestamps_equal_jax():
    """tests/test_engine.py:286: irregular frame times with a stall over
    1 s at frame 12 break the chains; the scalar walk takes those fish."""
    bg, frames = chip_smoke.synth_frames(30, n_fish=16, size=224, seed=3)
    s = _jax_settings(16, "base")
    det = detect_kwargs(s)
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.02, 0.08, len(frames)))
    times[12:] += 1.2
    ref = JaxFastTracker(s, bg)
    got = FastTracker(as_dict(s), bg)
    for i, img in enumerate(frames):
        ref.add_frame(i, float(times[i]),
                      **jax_label_blobs_raw(img, bg, **det))
        got.add_frame(i, float(times[i]), **label_blobs_raw(img, bg, **det))
    assert_history_equal(ref, got, len(frames))
    assert got.n_fish == ref.n_fish > 0


def test_rebuild_dacc_equals_jax():
    """tests/test_device_engine.py:368: the assist's rebuild of the
    accumulated walk reads the card's (F, W, 5) window."""
    from trex_tpu.config import reset_global_settings

    s = reset_global_settings()
    for k, v in dict(track_speed_decay=DECAY, track_max_speed=800,
                     cm_per_pixel=1.0).items():
        s.set(k, v)
    F, W = 4, T.DECAY_WIN
    win = np.zeros((F, W, 5))
    win[:, :, 0] = -1e9
    frame_times = {f: f / 25.0 for f in range(0, 40)}
    for k, f in enumerate(range(24, 31)):
        win[1, k] = (f, 10.0 + 2 * (f - 24), 5.0, f / 25.0, 0.04)
        win[3, k] = (f, 50.0 - 1.5 * (f - 24), 9.0 + 0.5 * (f - 24),
                     f / 25.0, 0.04)
    got_mask = np.array([True, False, False, False])
    prev = np.ones((F, 3))
    for frame in (30, 34):
        ref = jax_rebuild_dacc(win, got_mask, frame, prev, frame_times, s)
        got = _rebuild_dacc(win, got_mask, frame, prev, frame_times,
                            as_dict(s))
        np.testing.assert_array_equal(got, ref)
    assert np.all(got[0] == 0.0) and got[1, 0] > 0.0 \
        and 0 < got[1, 2] < 1e-4 and np.all(got[2] == 1.0)


def test_track_frames_with_posture_equals_jax():
    """Decay with posture on the fused path (the card's posture pass):
    the asymmetric scene in the product default, equal to the JAX
    package's DeviceTracker, postures by test_device_posture's rule."""
    from trex_tpu.config import reset_global_settings

    from test_device_posture import _compare_posture

    bg, frames, d = chip_smoke.asym_scene(n_frames=16)
    d = dict(d, track_speed_decay=DECAY)
    s = reset_global_settings()
    for k, v in d.items():
        s.set(k, v)
    ref = JaxDeviceTracker(s, bg, chunk=8).track_frames(frames)
    got = DeviceTracker(as_dict(s), bg, chunk=8,
                        device="cpu").track_frames(frames)
    assert got.P.do_decay and got.P.do_posture
    compare_engines(ref, got, len(frames))
    assert sorted(got.posture_history) == sorted(ref.posture_history)
    _compare_posture(ref, got, len(frames))


def test_carry_crosses_between_packages_with_decay():
    """convert.carry_from_jax / carry_to_numpy carry the motion window
    and the accumulated walk."""
    from trex_tpu_torch.convert import carry_from_jax, carry_to_numpy

    bg, frames, n, _ = scene_gap()
    s = _jax_settings(n, "base")
    P = J.params_from_settings(s)
    Pt = T.params_from_settings(as_dict(s))
    ref = jax.device_get(J.track_video_device(frames, bg, s, **CAPS))
    row = np.asarray(ref["carry_vec"])[13]
    carry = carry_from_jax(row, Pt, device="cpu")
    assert carry["win"].shape == (n, T.DECAY_WIN, 5)
    assert carry["dacc"].shape == (n, 3) and bool(carry["dacc"].any())
    np.testing.assert_array_equal(carry_to_numpy(carry), row)
    np.testing.assert_array_equal(
        carry["win"].numpy(),
        J.carry_from_vec_np(row, P)["win"].astype(np.float32))
