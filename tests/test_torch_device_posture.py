"""Port parity: ``trex_tpu_torch/ops/device_posture.py`` against the JAX
package's ``ops/device_posture.py`` on the CPU.

Contract: posture ``ok`` and ``overflow`` equal on every lane; lengths
within 1e-3 px and angles within 1e-4 rad (modulo 2 pi); the stages with
integer results equal (the trace's points x4 and count, the biggest
component's mask and size, the resample's count and overflow, the
tail and head indices, the walk's count)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_device_posture import _fish_frame, _posture_settings
from trex_tpu.ops import device_posture as J
from trex_tpu.ops.labeling import label_blobs
from trex_tpu_torch.ops import device_posture as P

from test_torch_engine import as_dict, one_torch_thread  # noqa: F401

TOL_LEN = 1e-3
TOL_ANG = 1e-4
N_FISH = 10
R = 256


def angle_diff(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def _runs(lines, slot=0):
    ry = np.full(R, -1, np.int32)
    rx0 = np.zeros(R, np.int32)
    rx1 = np.zeros(R, np.int32)
    rslot = np.full(R, 99, np.int32)
    n = len(lines)
    ry[:n], rx0[:n], rx1[:n] = lines[:, 0], lines[:, 1], lines[:, 2]
    rslot[:n] = slot
    return ry, rx0, rx1, rslot


@pytest.fixture(scope="module")
def fish():
    """The 10 curved fish of tests/test_device_posture.py, each as the
    arguments of make_posture_batch for one lane (every second one with
    a movement direction)."""
    rng = np.random.default_rng(1)
    bg = np.full((128, 128), 200, np.uint8)
    out = []
    for trial in range(N_FISH):
        img = _fish_frame(bg, 64, 64, rng.uniform(0, 2 * np.pi),
                          rng.uniform(16, 34), rng.uniform(5, 9),
                          rng.uniform(0, 6))
        blobs = label_blobs(img, bg, threshold=20, absolute=False,
                            track_threshold=20, track_absolute=False)
        b = max(blobs, key=lambda bb: bb.num_pixels)
        mv = rng.normal(0, 1, 2) if trial % 2 else None
        lines = np.asarray(b.lines, np.int32)
        pm = np.zeros((1, 2), np.float32) if mv is None \
            else np.asarray([mv], np.float32)
        out.append((img, bg, np.asarray([0], np.int32),
                    np.asarray([int(lines[:, 1].min())], np.int32),
                    np.asarray([int(lines[:, 0].min())], np.int32),
                    *_runs(lines), pm, np.asarray([True])))
    return out


@pytest.fixture(scope="module")
def specs():
    s = _posture_settings()
    spec = J.spec_from_settings(s, crop_h=64, crop_w=64)
    tspec = P.spec_from_settings(as_dict(s), crop_h=64, crop_w=64)
    assert tuple(spec) == tuple(tspec)
    return spec, tspec


@pytest.fixture(scope="module")
def jax_batch(specs):
    return jax.jit(J.make_posture_batch(specs[0]))


def _port(args):
    return [torch.as_tensor(a) for a in args]


def compare_posture(ref, got, keys=("ok", "overflow")):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]),
                                      err_msg=k)
    ok = np.asarray(ref["ok"])
    np.testing.assert_allclose(np.asarray(got["length"])[ok],
                               np.asarray(ref["length"])[ok], rtol=0,
                               atol=TOL_LEN)
    assert (angle_diff(np.asarray(got["angle"])[ok],
                       np.asarray(ref["angle"])[ok]) < TOL_ANG).all()


@pytest.mark.parametrize("trial", range(N_FISH))
def test_posture_blob_equals_jax(fish, specs, jax_batch, trial):
    args = fish[trial]
    ref = jax_batch(*[jnp.asarray(a) for a in args])
    got = P.make_posture_batch(specs[1])(*_port(args))
    assert bool(ref["ok"][0])
    compare_posture(ref, got)


@pytest.fixture(scope="module")
def stages(fish, specs):
    """Each JAX stage on the 10 fish, batched over lanes, with its input:
    the crops (diff, in_run), the masks at the posture threshold, then
    each stage fed with the JAX package's output of the stage before."""
    spec = specs[0]
    bg = jnp.asarray(fish[0][1])
    crop = jax.jit(jax.vmap(lambda f, bi, x0, y0, ry, rx0, rx1, rs:
                            J._crop_blob(f, bg, bi, x0, y0, ry, rx0, rx1,
                                         rs, spec)[:2]))
    cols = [np.stack([a[i] for a in fish]) for i in range(len(fish[0]))]
    diff, in_run = crop(jnp.asarray(cols[0]), jnp.asarray(cols[2][:, 0]),
                        jnp.asarray(cols[3][:, 0]), jnp.asarray(cols[4][:, 0]),
                        *(jnp.asarray(c) for c in cols[5:9]))
    keep = np.asarray(diff) >= spec.threshold
    out = dict(diff=np.asarray(diff), in_run=np.asarray(in_run), keep=keep)
    big = jax.jit(jax.vmap(lambda m: J._biggest_component(m, spec)))
    out["component"] = [np.array(x) for x in big(jnp.asarray(keep))]
    tr = jax.jit(jax.vmap(lambda d: J._trace4(d, spec)))
    out["trace"] = [np.array(x) for x in tr(out["component"][0])]
    rs = jax.jit(jax.vmap(lambda p, n: J._resample(p, n, spec)))
    out["resample"] = [np.array(x) for x in rs(*out["trace"][:2])]

    def outline(p, n):
        sm = J._smooth(p, n, spec)
        cw = J._make_clockwise(sm, n)
        return J._eft_approx(cw, n, spec)
    out["outline"] = np.array(jax.jit(jax.vmap(outline))(
        *out["resample"][:2]))
    th = jax.jit(jax.vmap(lambda p, n: J._tail_head(p, n, spec)))
    out["tail_head"] = [np.array(x)
                        for x in th(out["outline"], out["resample"][1])]
    Lo = out["resample"][1]
    rot = np.stack([out["outline"][i][np.mod(
        np.arange(out["outline"].shape[1]) + out["tail_head"][0][i],
        max(Lo[i], 1))] for i in range(N_FISH)])
    out["rot"] = rot
    walk = jax.jit(jax.vmap(lambda p, n: J._midline_walk(p, n, spec)))
    out["walk"] = [np.array(x) for x in walk(jnp.asarray(rot),
                                                jnp.asarray(Lo))]
    return out


def test_crop_equals_jax(fish, specs, stages):
    tspec = specs[1]
    for i, args in enumerate(fish):
        a = _port(args)
        diff, in_run, _ = P._crop_blob(a[0], a[1], a[2], a[3], a[4],
                                       a[5], a[6], a[7], a[8], tspec)
        np.testing.assert_array_equal(diff[0].numpy(), stages["diff"][i])
        np.testing.assert_array_equal(in_run[0].numpy(),
                                      stages["in_run"][i])


def test_biggest_component_equals_jax(specs, stages):
    dense, npx, ov = P._biggest_component(torch.as_tensor(stages["keep"]),
                                          specs[1])
    for got, ref in zip((dense, npx, ov), stages["component"]):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert (npx.numpy() > 20).all()


def test_trace_equals_jax(specs, stages):
    pts, n, ov = P._trace4(torch.as_tensor(stages["component"][0]),
                           specs[1])
    rp, rn, rov = stages["trace"]
    np.testing.assert_array_equal(n.numpy(), rn)
    np.testing.assert_array_equal(ov.numpy(), rov)
    np.testing.assert_array_equal((pts.numpy() * 4).astype(np.int64),
                                  (rp * 4).astype(np.int64))
    assert (rn > 50).all()


def test_resample_equals_jax(specs, stages):
    pts, n, _ = stages["trace"]
    out, m, ov = P._resample(torch.as_tensor(pts), torch.as_tensor(n),
                             specs[1])
    rout, rm, rov = stages["resample"]
    np.testing.assert_array_equal(m.numpy(), rm)
    np.testing.assert_array_equal(ov.numpy(), rov)
    np.testing.assert_allclose(out.numpy(), rout, rtol=0, atol=1e-4)


def test_outline_and_tail_head_equal_jax(specs, stages):
    pts, m, _ = stages["resample"]
    tspec = specs[1]
    pm = torch.as_tensor(m)
    ap = P._eft_approx(P._make_clockwise(
        P._smooth(torch.as_tensor(pts), pm, tspec), pm), pm, tspec)
    np.testing.assert_allclose(ap.numpy(), stages["outline"], rtol=0,
                               atol=1e-4)
    # the indices, from the JAX package's outline
    tail, head, peak = P._tail_head(torch.as_tensor(stages["outline"]), pm,
                                    tspec)
    for got, ref in zip((tail, head, peak), stages["tail_head"]):
        np.testing.assert_array_equal(got.numpy(), ref)


def test_midline_walk_equals_jax(specs, stages):
    segs, hts, m = P._midline_walk(torch.as_tensor(stages["rot"]),
                                   torch.as_tensor(stages["resample"][1]),
                                   specs[1])
    rsegs, rhts, rm = stages["walk"]
    np.testing.assert_array_equal(m.numpy(), rm)
    assert (rm > 10).all()
    np.testing.assert_allclose(segs.numpy(), rsegs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(hts.numpy(), rhts, rtol=0, atol=1e-4)


def test_prefix_sum_in_the_jax_order():
    """_cumsum rounds like jnp.cumsum on the CPU, for lengths in and
    past one block and past two levels of blocks."""
    rng = np.random.default_rng(0)
    for n in (5, 16, 17, 100, 300, 2048):
        x = (rng.random((3, n)) * 0.7).astype(np.float32)
        ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=-1))(x))
        np.testing.assert_array_equal(P._cumsum(torch.as_tensor(x)).numpy(),
                                      ref)


def test_small_trace_cap_overflows_like_jax(fish, specs):
    """A max_trace below the fish's perimeter: every lane overflows."""
    spec = specs[0]._replace(max_trace=64)
    tspec = specs[1]._replace(max_trace=64)
    fn = jax.jit(J.make_posture_batch(spec))
    for args in fish[:3]:
        ref = fn(*[jnp.asarray(a) for a in args])
        got = P.make_posture_batch(tspec)(*_port(args))
        assert bool(ref["overflow"][0])
        compare_posture(ref, got)


def _grid(fish, T=3, F=4):
    """(T, F) lanes over T frames of the first fish images, each frame
    with the fish in slot 0 and the lane's blob in `bi`; lanes (t, 1)
    and (t, 3) and all of frame 1 but one inactive."""
    frames = np.stack([fish[t][0] for t in range(T)])
    bg = fish[0][1]
    bi = np.zeros((T, F), np.int32)
    bx0 = np.stack([np.full(F, fish[t][3][0]) for t in range(T)]) \
        .astype(np.int32)
    by0 = np.stack([np.full(F, fish[t][4][0]) for t in range(T)]) \
        .astype(np.int32)
    runs = [np.stack([fish[t][5 + k] for t in range(T)]) for k in range(4)]
    active = np.ones((T, F), bool)
    active[:, 1] = active[:, 3] = False
    active[1, 2] = False
    return frames, bg, bi, bx0, by0, runs, active


def test_lanes_batched_and_select_scan_equal_jax(fish, specs):
    spec, tspec = specs
    frames, bg, bi, bx0, by0, runs, active = _grid(fish)
    args = (frames, bg, bi, bx0, by0, *runs, active)
    ref = jax.jit(lambda *a: J.posture_lanes_batched(*a, spec))(
        *[jnp.asarray(a) for a in args])
    got = P.posture_lanes_batched(*_port(args), tspec)
    for k in ("ok", "overflow"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    np.testing.assert_allclose(got["dir_entry"].numpy(),
                               np.asarray(ref["dir_entry"]), rtol=0,
                               atol=1e-5)
    for v in ("fwd", "rev"):
        np.testing.assert_array_equal(got[v]["norm_ok"].numpy(),
                                      np.asarray(ref[v]["norm_ok"]))
        np.testing.assert_allclose(got[v]["length"].numpy(),
                                   np.asarray(ref[v]["length"]), rtol=0,
                                   atol=TOL_LEN)
        assert (angle_diff(got[v]["angle"].numpy(),
                           np.asarray(ref[v]["angle"])) < TOL_ANG).all()
    # inactive lanes: nothing runs, every output is the empty chain's
    assert not got["ok"].numpy()[~active].any()
    assert (got["fwd"]["length"].numpy()[~active] == 0).all()

    rng = np.random.default_rng(4)
    pdir0 = rng.normal(0, 1, (4, 2)).astype(np.float32)
    pdir0[0] = 0.0
    rsel = jax.jit(lambda o, p: J.posture_select_scan(o, p, spec))(
        ref, jnp.asarray(pdir0))
    gsel = P.posture_select_scan(got, torch.as_tensor(pdir0), tspec)
    np.testing.assert_array_equal(gsel[2].numpy(), np.asarray(rsel[2]))
    ok = np.asarray(rsel[2])
    assert ok.sum() == active.sum()
    np.testing.assert_allclose(gsel[0].numpy(), np.asarray(rsel[0]),
                               rtol=0, atol=TOL_LEN)
    assert (angle_diff(gsel[1].numpy(), np.asarray(rsel[1])) < TOL_ANG).all()
    for i in (3, 4):
        np.testing.assert_allclose(gsel[i].numpy(), np.asarray(rsel[i]),
                                   rtol=0, atol=1e-5)
