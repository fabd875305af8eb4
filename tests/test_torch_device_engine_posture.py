"""Port parity with ``calculate_posture`` on: the port's DeviceTracker
(``device="cpu"``) and its packed entry points against the JAX package's
on the CPU.

Equal: the tracking outputs (assists, fish rows, split-child flags,
``needs_host`` with the posture pass's flags, positions), as in
``test_torch_device_engine.py``; the posture ``ok`` flags. Lengths within
1e-3 px and angles within 1e-4 rad of the JAX package's device posture;
on the blob path, where both packages run the same native chain on the
host, the posture history exactly. Against the host FastTracker the
JAX package's own rule holds (``tests/test_device_posture.py::
_compare_posture``: equal ``ok``, length within 0.05 px, angle within
1e-3 rad)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_device_posture import _asym_frames, _compare_posture, \
    _posture_settings
from trex_tpu.ops import device_posture as JP
from trex_tpu.ops import device_tracker as J
from trex_tpu.ops.labeling import label_blobs as jax_label_blobs
from trex_tpu.ops.runcc import detect_batch_runs as jax_runs
from trex_tpu.track.blob import TrackBlob as JaxTrackBlob
from trex_tpu.track.device_engine import DeviceTracker as JaxDeviceTracker
from trex_tpu_torch.config import SettingsView
from trex_tpu_torch.convert import carry_from_jax, carry_to_numpy
from trex_tpu_torch.ops import device_posture as TP
from trex_tpu_torch.ops import device_tracker as T
from trex_tpu_torch.ops.labeling import label_blobs, label_blobs_raw
from trex_tpu_torch.track.blob import TrackBlob
from trex_tpu_torch.track.device_engine import (DeviceTracker,
                                                export_positions)
from trex_tpu_torch.track.engine import FastTracker

from test_torch_device_engine import _feed, compare_engines
from test_torch_device_engine_automatic import crossing_frames
from test_torch_device_tracker import RTOL
from test_torch_engine import as_dict, one_torch_thread  # noqa: F401

TOL_LEN = 1e-3
TOL_ANG = 1e-4
CAPS = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
            max_child_runs=1024, max_children=64)


def _settings(n, mode="automatic", **over):
    s = _posture_settings(n)
    s.set("match_mode", mode)
    for k, v in over.items():
        s.set(k, v)
    return s


def compare_posture_history(ref, got, n_frames, exact=False):
    assert sorted(got.posture_history) == sorted(ref.posture_history)
    for f in range(n_frames):
        a = ref.posture_history.get(f)
        b = got.posture_history.get(f)
        if a is None:
            continue
        for k in ("fish", "ok"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{f} {k}")
        ok = np.asarray(a["ok"], bool)
        if exact:
            for k in ("midline_length", "angle"):
                np.testing.assert_array_equal(b[k], a[k])
            continue
        np.testing.assert_allclose(b["midline_length"][ok],
                                   a["midline_length"][ok], rtol=0,
                                   atol=TOL_LEN)
        d = np.abs(b["angle"][ok] - a["angle"][ok])
        assert (np.minimum(d, 2 * np.pi - d) < TOL_ANG).all(), f


def host_tracker(frames, bg, s):
    """The port's FastTracker over `frames` (settings: the JAX package's
    object or a plain dict over the port's defaults), labelled like
    tests/test_device_posture.py::_host_tracker."""
    d = s if isinstance(s, dict) else as_dict(s)
    tr = FastTracker(d, bg)
    det = dict(threshold=int(SettingsView(d)["detect_threshold"]),
               absolute=False,
               track_threshold=int(SettingsView(d)["track_threshold"]),
               track_absolute=False)
    for i, fr in enumerate(frames):
        tr.add_frame(i, i / 25.0, **label_blobs_raw(fr, bg, **det))
    return tr


@pytest.fixture(scope="module")
def asym():
    bg, frames = _asym_frames(4, 30)
    return bg, np.stack(frames)


def test_crossing_replays_split_children_like_jax():
    """The product default on two fish that merge: the pieces split on
    the card carry no run tables, so posture flags those frames and the
    host replays them, as in the JAX package."""
    bg, frames = crossing_frames(16, hold=1)
    s = _settings(2, track_size_filter=[[10, 120]])
    ref = JaxDeviceTracker(s, bg, chunk=16).track_frames(frames)
    got = DeviceTracker(as_dict(s), bg, chunk=16,
                        device="cpu").track_frames(frames)
    compare_engines(ref, got, len(frames))
    assert got.assist_frames
    compare_posture_history(ref, got, len(frames))


@pytest.mark.parametrize("mode,chunk", [("approximate", 16),
                                        ("automatic", 30)])
def test_fused_path_posture_equals_jax(asym, mode, chunk):
    """track_frames: posture on the card with no assist, equal to the JAX
    DeviceTracker and held to the host FastTracker (over two chunks, the
    direction carried across, and over one)."""
    bg, frames = asym
    s = _settings(4, mode)
    ref = JaxDeviceTracker(s, bg, chunk=chunk).track_frames(frames)
    got = DeviceTracker(as_dict(s), bg, chunk=chunk,
                        device="cpu").track_frames(frames)
    compare_engines(ref, got, len(frames))
    assert not got.assist_frames
    compare_posture_history(ref, got, len(frames))
    assert len(got.posture_history) == len(frames)
    _compare_posture(host_tracker(frames, bg, s), got, len(frames))


def test_blob_path_posture_equals_jax(asym):
    """add_frame_blobs: posture on the host over each committed span, the
    same native chain as the JAX package's, so the histories are equal."""
    bg, frames = asym
    s = _settings(4)
    det = dict(threshold=int(s["detect_threshold"]), absolute=False,
               track_threshold=20, track_absolute=False)
    ref = _feed(JaxDeviceTracker(s, bg, chunk=16), jax_label_blobs,
                JaxTrackBlob, frames, bg, det)
    got = _feed(DeviceTracker(as_dict(s), bg, chunk=16, device="cpu"),
                label_blobs, TrackBlob, frames, bg, det)
    compare_engines(ref, got, len(frames))
    compare_posture_history(ref, got, len(frames), exact=True)
    _compare_posture(host_tracker(frames, bg, s), got, len(frames))


def test_positions_export_includes_posture(tmp_path):
    bg, frames = _asym_frames(3, 12, seed=5)
    dev = DeviceTracker(as_dict(_settings(3)), bg, chunk=8,
                        device="cpu").track_frames(np.stack(frames))
    out = tmp_path / "pos.npz"
    export_positions(dev, out)
    d = np.load(out)
    assert {"midline_length", "midline_angle", "posture_ok"} <= set(d.files)
    assert d["posture_ok"].any()
    assert (d["midline_length"][d["posture_ok"]] > 1.0).all()


def _packed_args(s):
    d = as_dict(s)
    P = J.params_from_settings(s)
    Pt = T.params_from_settings(d)
    assert tuple(Pt) == tuple(P)
    return d, P, Pt, J._detect_kwargs(s, CAPS)


def _compare_packed(got, ref, n, P, Pt):
    h_ref, rows_ref = J.unpack_result(np.asarray(ref), n, P)
    h_got, rows_got = T.unpack_result(got, n, Pt)
    for k in ("fish_row", "fish_seen", "fish_child", "needs_host",
              "detect_overflow", "n_assigned", "fish_x", "fish_y", "p_ok"):
        np.testing.assert_array_equal(h_got[k], h_ref[k], err_msg=k)
    ok = h_ref["p_ok"]
    np.testing.assert_allclose(h_got["p_len"][ok], h_ref["p_len"][ok],
                               rtol=0, atol=TOL_LEN)
    d = np.abs(h_got["p_ang"][ok] - h_ref["p_ang"][ok])
    assert (np.minimum(d, 2 * np.pi - d) < TOL_ANG).all()
    base = J._track_vec_size(P)
    np.testing.assert_allclose(rows_got[:, :base], rows_ref[:, :base],
                               rtol=RTOL, atol=0)
    np.testing.assert_allclose(rows_got[:, base:], rows_ref[:, base:],
                               rtol=0, atol=1e-5)
    return h_got, rows_got


def test_fused_scan_packed_resumes_across_packages(asym):
    """fused_scan_packed with the posture spec over the first half in one
    package and the second half in the other, from its carry row (the
    posture-direction section included, through convert.py), equals
    each package's own second half."""
    bg, frames = asym
    s = _settings(4)
    d, P, Pt, kw = _packed_args(s)
    spec = JP.spec_from_settings(s, crop_h=96, crop_w=96)
    spec_t = TP.spec_from_settings(d, crop_h=96, crop_w=96)
    assert tuple(spec_t) == tuple(spec)
    split = J.default_split_spec(s, P)
    split_t = T.default_split_spec(d, Pt)
    n = len(frames)
    half = n // 2
    times = np.arange(n, dtype=np.float32) / np.float32(25.0)
    c0 = J.carry_to_vec(dict(J._init_carry(P, 0, 0.0),
                             posture_dir=np.zeros((P.max_fish, 2))))
    assert len(c0) == T.carry_vec_size(Pt)

    def jax_run(lo, hi, carry):
        aux = J.make_aux(carry, times[lo:hi], np.arange(lo, hi))
        return np.asarray(J.launch_resilient(
            J.fused_scan_packed, jnp.asarray(frames[lo:hi]),
            jnp.asarray(bg), jnp.asarray(aux), P, split_spec=split,
            posture_spec=spec, **kw))

    def port_run(lo, hi, carry):
        aux = T.make_aux(carry, times[lo:hi], np.arange(lo, hi))
        return T.fused_scan_packed(frames[lo:hi], bg, aux, Pt,
                                   split_spec=split_t, posture_spec=spec_t,
                                   device="cpu", **kw)

    ref1 = jax_run(0, half, c0)
    h1, rows1 = _compare_packed(port_run(0, half, c0), ref1, half, P, Pt)
    assert h1["p_ok"].any()
    _, jrows1 = J.unpack_result(ref1, half, P)
    # the JAX carry row through convert.py, posture section included
    carry = carry_from_jax(jrows1[-1], Pt, device="cpu")
    np.testing.assert_array_equal(carry_to_numpy(carry), jrows1[-1])
    assert np.abs(carry["posture_dir"].numpy()).sum() > 0
    ref2 = jax_run(half, n, jrows1[-1])
    _compare_packed(port_run(half, n, jrows1[-1]), ref2, n - half, P, Pt)
    # and the JAX package continuing from the port's row
    ref2b = jax_run(half, n, rows1[-1])
    _compare_packed(port_run(half, n, rows1[-1]), ref2b, n - half, P, Pt)


@pytest.mark.parametrize("case", ["too_big", "disabled"])
def test_fused_posture_flags_equal_jax(asym, case):
    """Frames the posture pass hands to the host: blobs too big for the
    crop (here a 12 px crop), and with no enabled spec every frame with
    an assignment (the JAX package's branch)."""
    bg, frames = asym
    frames = frames[:8]
    s = _settings(4, "approximate")
    d, P, Pt, kw = _packed_args(s)
    if case == "too_big":
        spec = JP.spec_from_settings(s, crop_h=12, crop_w=12)
        spec_t = TP.spec_from_settings(d, crop_h=12, crop_w=12)
    else:
        spec = spec_t = None
    n = len(frames)
    c0 = J.carry_to_vec(dict(J._init_carry(P, 0, 0.0),
                             posture_dir=np.zeros((P.max_fish, 2))))
    aux = J.make_aux(c0, np.arange(n, dtype=np.float32) / np.float32(25.0),
                     np.arange(n))
    ref = np.asarray(J.launch_resilient(
        J.fused_scan_packed, jnp.asarray(frames), jnp.asarray(bg),
        jnp.asarray(aux), P, posture_spec=spec, **kw))
    got = T.fused_scan_packed(frames, bg, aux, Pt, posture_spec=spec_t,
                              device="cpu", **kw)
    h, _ = _compare_packed(got, ref, n, P, Pt)
    assert h["needs_host"].all()


def test_scan_packed_with_posture_equals_jax(asym):
    """scan_packed has no pixels: the posture fields stay empty and the
    carry's posture section rides through, as in the JAX package."""
    bg, frames = asym
    frames = frames[:6]
    s = _settings(4, "approximate", track_do_history_split=False)
    d, P, Pt, kw = _packed_args(s)
    out = jax.device_get(jax_runs(jnp.asarray(frames), jnp.asarray(bg),
                                  **kw))
    det = J.detections_from_runcc(out, P)
    B = det["cx"].shape[1]
    det_packed = np.concatenate(
        [np.asarray(det[k], np.float32) for k in
         ("cx", "cy", "bcx", "bcy", "recount", "valid")], axis=1)
    n = len(frames)
    pdir = np.random.default_rng(2).normal(0, 1, (P.max_fish, 2))
    c0 = J.carry_to_vec(dict(J._init_carry(P, 0, 0.0), posture_dir=pdir))
    aux = J.make_aux(c0, np.arange(n, dtype=np.float32) / np.float32(25.0),
                     np.arange(n))
    ref = np.asarray(J.launch_resilient(
        J.scan_packed, jnp.asarray(det_packed), jnp.asarray(aux), P, B, 0))
    got = T.scan_packed(det_packed, aux, Pt, B, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=0)
    h, rows = T.unpack_result(got, n, Pt)
    assert not h["p_ok"].any()
    np.testing.assert_array_equal(
        rows[:, T._track_vec_size(Pt):],
        np.broadcast_to(pdir.astype(np.float32).ravel(), (n, 2 * 4)))


def test_port_defaults_with_posture_run(asym):
    """The port's defaults have calculate_posture on: given only what
    every engine needs (a track threshold over the background, a bounded
    population, a maximum speed), the host FastTracker and the DeviceTracker on both paths
    (fused_scan_packed, scan_packed) run with posture; posture records of
    archive mode come back for every row with a posture, and a row with
    a pose prediction takes its posture from the keypoints."""
    from trex_tpu_torch.config import DEFAULTS
    from trex_tpu_torch.track.archive import compute_posture_rows
    from trex_tpu_torch.track.posture import calculate_posture_from_pose

    bg, frames = asym
    frames = frames[:6]
    d = dict(track_max_individuals=4, track_max_speed=300,
             track_threshold=20, track_background_subtraction=True,
             track_threshold_is_absolute=False)
    assert DEFAULTS["calculate_posture"] and DEFAULTS["match_mode"] \
        == "automatic" and DEFAULTS["track_do_history_split"]
    host = host_tracker(frames, bg, d)
    fused = DeviceTracker(d, bg, chunk=4, device="cpu").track_frames(frames)
    det = dict(threshold=15, absolute=True, track_threshold=20,
               track_absolute=False)
    blobs = _feed(DeviceTracker(d, bg, chunk=4, device="cpu"), label_blobs,
                  TrackBlob, frames, bg, det)
    for tr in (host, fused, blobs):
        assert tr.posture_history and sum(
            int(np.sum(h["ok"])) for h in tr.posture_history.values()) > 0
    b = label_blobs(frames[0], bg, **det)
    ok, lens, _, _, recs, _ = compute_posture_rows(
        d, bg, [x.lines for x in b], [x.pixels for x in b], None,
        np.zeros((len(b), 2)), want_recs=True)
    assert ok.any() and all((r is not None) == o for r, o in zip(recs, ok))
    assert all(r.len_px == ln for r, ln in zip(recs, lens) if r is not None)
    # a row with a pose prediction takes its posture from the keypoints
    x, y, w, h = TrackBlob(b[0].lines, b[0].pixels).bounds
    kp = np.stack([np.linspace(x, x + w - 1, 5), np.full(5, y + h / 2)], 1)
    ok1, lens1, _, _, _, _ = compute_posture_rows(
        d, bg, [b[0].lines], [b[0].pixels], [{"keypoints": kp}],
        np.zeros((1, 2)))
    want = calculate_posture_from_pose(TrackBlob(b[0].lines, b[0].pixels),
                                       kp, d)
    assert ok1[0] and lens1[0] == want.midline.len
