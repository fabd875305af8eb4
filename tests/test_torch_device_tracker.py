"""Port parity: trex_tpu_torch's device tracking chunk vs trex_tpu's on
the CPU, base configuration (approximate matching, no history split, no
posture, no speed decay).

Tolerance. Integer outputs (fish_row, fish_seen, needs_host, n_assigned,
n_fish, detect overflow) are exactly equal. fish_x / fish_y are
bit-equal: they are copied centroids. fish_prob and the packed carry
rows are held to rtol=2e-6: XLA-CPU and ATen may round pow, sqrt and
fused multiply-adds differently in the probability and error-band
arithmetic; the integer decisions are protected by the deferral bands
that raise needs_host."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from trex_tpu.config import reset_global_settings
from trex_tpu.ops import device_tracker as J
from trex_tpu.ops.runcc import detect_batch_runs as jax_runs
from trex_tpu_torch.config import DEFAULTS
from trex_tpu_torch.convert import carry_from_jax, carry_to_numpy
from trex_tpu_torch.ops import device_tracker as T
from trex_tpu_torch.ops.runcc import detect_batch_runs

from test_torch_runcc import synth_scene

RTOL = 2e-6
CAPS = dict(max_runs=512, max_pixels=8192, max_blobs=32,
            max_child_runs=512, max_children=32)


def _settings(n_fish):
    s = reset_global_settings()
    s.set("track_max_individuals", n_fish)
    s.set("track_max_speed", 300)
    s.set("cm_per_pixel", 1.0)
    s.set("frame_rate", 25)
    s.set("track_threshold", 20)
    s.set("track_threshold_is_absolute", False)
    s.set("track_background_subtraction", True)
    s.set("track_size_filter", [[10, 400]])
    s.set("calculate_posture", False)
    s.set("match_mode", "approximate")
    s.set("track_do_history_split", False)
    return s


def _as_dict(s):
    return {k: s[k] for k in DEFAULTS}


def _render(positions, size=256):
    img = np.full((size, size), 200, np.uint8)
    for p in positions:
        if p is None:
            continue
        x, y = int(p[0]), int(p[1])
        img[y:y + 6, x:x + 10] = 80
    return img


def _dense_scene():
    n_fish = 4
    rng = np.random.default_rng(0)
    pos = np.array([[30.0 + 50 * i, 40.0 + 40 * i] for i in range(n_fish)])
    vel = rng.normal(0, 1.5, (n_fish, 2))
    frames = []
    for _ in range(40):
        vel += rng.normal(0, 0.4, vel.shape)
        np.clip(vel, -3, 3, out=vel)
        pos += vel
        pos = np.clip(pos, 10, 230)
        frames.append(_render(pos))
    return n_fish, np.stack(frames), np.full((256, 256), 200, np.uint8)


def _reactivation_scene():
    n_fish = 3
    base = np.array([[40.0, 60.0], [120.0, 60.0], [200.0, 120.0]])
    gap = range(12, 32)
    frames = []
    for f in range(45):
        pts = [None if (i == 1 and f in gap) else base[i] + [0.8 * f, 0.3 * f]
               for i in range(n_fish)]
        frames.append(_render(pts))
    return n_fish, np.stack(frames), np.full((256, 256), 200, np.uint8)


def _compare_hist(ref, got):
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "n_assigned", "n_fish", "detect_overflow"):
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      np.asarray(ref[k]), err_msg=k)
    for k in ("fish_x", "fish_y"):
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      np.asarray(ref[k]), err_msg=k)
    for k in ("fish_prob", "carry_vec"):
        np.testing.assert_allclose(got[k].cpu().numpy(), np.asarray(ref[k]),
                                   rtol=RTOL, atol=0, err_msg=k)


def _synth():
    bg, frames = synth_scene(24, 24, 128, seed=3)
    s = _settings(24)
    s.set("track_size_filter", [[20, 400]])
    return 24, frames, bg, s


@pytest.mark.parametrize("scene", ["dense", "reactivation", "synth"])
def test_track_video_device_equals_jax(scene):
    if scene == "synth":
        n_fish, frames, bg, s = _synth()
    else:
        n_fish, frames, bg = (_dense_scene() if scene == "dense"
                              else _reactivation_scene())
        s = _settings(n_fish)
    ref = jax.device_get(J.track_video_device(frames, bg, s, **CAPS))
    got = T.track_video_device(frames, bg, _as_dict(s), device="cpu",
                               **CAPS)
    assert int(got["n_fish"]) > 0
    _compare_hist(ref, got)
    vec = J.carry_to_vec(ref["final_carry"])
    np.testing.assert_allclose(carry_to_numpy(got["final_carry"]), vec,
                               rtol=RTOL, atol=0)
    P = J.params_from_settings(s)
    host_ref = J.carry_from_vec_np(vec, P)
    host_got = T.carry_from_vec_np(vec, T.params_from_settings(_as_dict(s)))
    assert set(host_got) == set(host_ref)
    for k, v in host_ref.items():
        np.testing.assert_array_equal(host_got[k], v, err_msg=k)


def test_fused_scan_packed_equals_jax_and_unpacks():
    n_fish, frames, bg, s = _synth()
    frames = frames[:12]
    P = J.params_from_settings(s)
    Pt = T.params_from_settings(_as_dict(s))
    assert tuple(Pt) == tuple(P)
    kw = J._detect_kwargs(s, CAPS)
    assert T._detect_kwargs(_as_dict(s), CAPS) == kw
    times = np.arange(12, dtype=np.float32) / np.float32(25.0)
    carry0 = J.carry_to_vec(J._init_carry(P, 0, 0.0))
    aux = J.make_aux(carry0, times, np.arange(12))
    ref = np.asarray(J.fused_scan_packed(jnp.asarray(frames),
                                         jnp.asarray(bg), jnp.asarray(aux),
                                         P, **kw))
    got = T.fused_scan_packed(frames, bg, aux, Pt, device="cpu", **kw)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)
    h_ref, rows_ref = J.unpack_result(ref, 12, P)
    h_got, rows_got = T.unpack_result(got, 12, Pt)
    for k in h_ref:
        if k in ("fish_prob",):
            continue
        np.testing.assert_array_equal(h_got[k], h_ref[k], err_msg=k)
    # the packed result of the fused path equals the dict path's fields
    hist = T.track_video_device(frames, bg, _as_dict(s), device="cpu",
                                **CAPS)
    for k in ("fish_x", "fish_y", "fish_seen", "fish_row", "n_assigned",
              "needs_host", "detect_overflow"):
        np.testing.assert_array_equal(h_got[k], hist[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(rows_got, hist["carry_vec"].numpy())


def test_scan_packed_equals_jax():
    n_fish, frames, bg = _dense_scene()
    s = _settings(n_fish)
    P = J.params_from_settings(s)
    out = jax.device_get(jax_runs(jnp.asarray(frames), jnp.asarray(bg),
                                  **J._detect_kwargs(s, CAPS)))
    det = J.detections_from_runcc(out, P)
    B = 32
    det_packed = np.concatenate(
        [np.asarray(det[k], np.float32) for k in
         ("cx", "cy", "bcx", "bcy", "recount", "valid")], axis=1)
    Tn = frames.shape[0]
    times = np.arange(Tn, dtype=np.float32) / np.float32(25.0)
    aux = J.make_aux(J.carry_to_vec(J._init_carry(P, 0, 0.0)), times,
                     np.arange(Tn))
    ref = np.asarray(J.scan_packed(jnp.asarray(det_packed),
                                   jnp.asarray(aux), P, B, 0))
    got = T.scan_packed(det_packed, aux, T.params_from_settings(
        _as_dict(s)), B, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)


def test_resume_from_jax_carry():
    """JAX tracks frames 0-19; its final carry, packed, resumes the port
    on frames 20-39, which must equal JAX's own frames 20-39."""
    _, _, _, s = _synth()
    bg, frames = synth_scene(40, 24, 128, seed=3)
    P = J.params_from_settings(s)
    kw = J._detect_kwargs(s, CAPS)
    out = jax.device_get(jax_runs(jnp.asarray(frames), jnp.asarray(bg),
                                  **kw))
    det = J.detections_from_runcc(out, P)
    times = np.arange(40, dtype=np.float32) / np.float32(25.0)
    fidx = np.arange(40, dtype=np.int32)
    first = {k: v[:20] for k, v in det.items()}
    second = {k: v[20:] for k, v in det.items()}
    h1 = J.track_scan(first, jnp.asarray(times[:20]),
                      jnp.asarray(fidx[:20]), P)
    vec = J.carry_to_vec(jax.device_get(h1["final_carry"]))
    ref = jax.device_get(J.track_scan(
        second, jnp.asarray(times[20:]), jnp.asarray(fidx[20:]), P,
        carry0=h1["final_carry"]))

    Pt = T.params_from_settings(_as_dict(s))
    carry0 = carry_from_jax(vec, Pt, device="cpu")
    np.testing.assert_array_equal(carry_to_numpy(carry0), vec)
    tout = detect_batch_runs(frames[20:], bg, device="cpu", **kw)
    got = T.track_scan(T.detections_from_runcc(tout, Pt),
                       torch.as_tensor(times[20:]),
                       torch.as_tensor(fidx[20:]), Pt, carry0=carry0)
    got["detect_overflow"] = tout["overflow"]
    ref["detect_overflow"] = np.asarray(out["overflow"])[20:]
    assert np.asarray(ref["fish_seen"]).any()
    _compare_hist(ref, got)


@pytest.mark.parametrize("key,value", [
    ("track_speed_decay", 0.8),
    ("track_speed_decay", 0.0),
    ("calculate_posture", True),
])
def test_later_slice_configs_raise(key, value):
    s = _as_dict(_settings(2))
    s[key] = value
    frames = np.full((1, 32, 32), 200, np.uint8)
    with pytest.raises(NotImplementedError, match="later slice"):
        T.track_video_device(frames, frames[0], s, device="cpu", **CAPS)


def test_plain_dict_defaults():
    """Missing keys fall back to the JAX package's defaults."""
    P = T.params_from_settings({})
    assert tuple(P) == tuple(J.params_from_settings(reset_global_settings()))
