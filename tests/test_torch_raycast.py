"""The visual-field projection (trex_tpu_torch/ops/raycast.py) against
the JAX package's (trex_tpu/ops/raycast.py): the unit cases of
tests/test_visual_field.py and seeded scenes of 8-64 fish with 32-256
points a fish and view-blocking shapes, every plane equal to the jitted
``_visual_field``'s on the CPU (tolerance 0). JAX is imported only by
the twin tests, so the test marked ``cuda`` (the card against the CPU
path, by chip_smoke.vf_departures' rule) runs on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_raycast.py

and skips without one."""
import numpy as np
import pytest
import torch

import chip_smoke
from trex_tpu_torch.ops import raycast as T
from trex_tpu_torch.ops.labeling import atan2f

PLANES = ("depth0", "id0", "fov0", "depth1", "id1", "fov1")


@pytest.fixture(scope="module")
def J():
    from trex_tpu.ops import raycast

    return raycast


def _circle(cx, cy, r=5.0, n=40):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)],
                    1).astype(np.float32)


def _one_eye(pts, ids):
    return (pts, np.asarray(ids, np.int32), np.ones(len(pts), bool),
            np.zeros((1, 2, 2), np.float32), np.zeros((1, 2), np.float32),
            np.float32(1000.0))


def _both(J, inputs):
    """(port planes, JAX planes) as numpy, after holding them equal."""
    got = {k: v.numpy() for k, v in
           T.visual_field(*inputs, device="cpu").items()}
    want = {k: np.asarray(v) for k, v in J.visual_field(*inputs).items()}
    assert list(got) == list(want)
    for k in PLANES:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def test_single_object_straight_ahead(J):
    out = _both(J, _one_eye(_circle(100, 0), np.full(40, 7)))
    mid = T.FIELD_RESOLUTION // 2
    assert out["depth0"][0, 0, mid] == pytest.approx(95.0, abs=1.0)
    assert out["id0"][0, 0, mid] == 7
    assert out["id0"][0, 0, 5] == -1 and out["id0"][0, 0, -5] == -1
    expect = (1 - (95.0 / 1000.0) ** 2) ** 2 * 255
    assert abs(int(out["fov0"][0, 0, mid]) - int(expect)) <= 3


def test_occlusion_two_layers(J):
    pts = np.concatenate([_circle(50, 0), _circle(120, 0)])
    out = _both(J, _one_eye(pts, [1] * 40 + [2] * 40))
    mid = T.FIELD_RESOLUTION // 2
    assert out["id0"][0, 0, mid] == 1
    assert out["id1"][0, 0, mid] == 2
    assert out["depth1"][0, 0, mid] > out["depth0"][0, 0, mid]


def test_fov_limits(J):
    out = _both(J, _one_eye(_circle(-100, 0), np.zeros(40)))
    assert (out["id0"][0] == -1).all()


@pytest.mark.parametrize("seed,n_fish,n_points", [
    (0, 8, 32), (1, 16, 64), (2, 32, 128), (3, 64, 256), (4, 8, 256),
    (5, 64, 32), (6, 24, 200), (7, 48, 96)])
def test_seeded_scenes_equal_jitted_jax(J, seed, n_fish, n_points):
    import jax.numpy as jnp

    pts, ids, valid, eye_pos, eye_angle, max_d = chip_smoke.vf_scene(
        seed, n_fish, n_points)
    want = J._visual_field(jnp.asarray(pts), jnp.asarray(ids),
                           jnp.asarray(valid.astype(np.int32)),
                           jnp.asarray(eye_pos), jnp.asarray(eye_angle),
                           float(max_d))
    got = T.visual_field(pts, ids, valid, eye_pos, eye_angle, max_d,
                         device="cpu")
    assert (got["id0"] >= n_fish).any() and (got["id1"] >= 0).any()
    for k in PLANES:
        assert got[k].shape == (n_fish, 2, T.FIELD_RESOLUTION), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_one_rounding_of_1_plus_r2_holds_for_every_float32():
    """_one_rounding_1p_sq's premise: 1 + r*r summed in float64 (r*r is
    exact there) and rounded to float32 is the once-rounded result for
    every float32 r in [0, 1], because no inexact float64 sum lands on a
    float32 midpoint. Below 2^-12, 1 + r*r is under 1 + 2^-24 and has no
    midpoint to land on; from there every float32 is checked."""
    lo = int(np.float32(2.0 ** -12).view(np.uint32))
    hi = int(np.float32(1.0).view(np.uint32))
    for start in range(lo, hi + 1, 1 << 22):
        u = np.arange(start, min(start + (1 << 22), hi + 1),
                      dtype=np.uint32)
        r = u.view(np.float32).astype(np.float64)
        sq = r * r
        s = 1.0 + sq
        frac = (s - 1.0) * 2.0 ** 23
        inexact_mid = ((frac - np.floor(frac)) == 0.5) & (sq != s - 1.0)
        assert not inexact_mid.any(), r[inexact_mid][:4]
    r = torch.tensor([0.0, 2.0 ** -12, 0.5, 0.999, 1.0])
    want = (1.0 + r.double() ** 2).float()
    assert torch.equal(T._one_rounding_1p_sq(r), want)


def test_cpu_angles_are_the_c_library_atan2f():
    """The CPU path's atan2 is the C library's atan2f (the jitted JAX
    program's), element by element."""
    import ctypes
    import ctypes.util

    libm = ctypes.CDLL(ctypes.util.find_library("m"))
    libm.atan2f.restype = ctypes.c_float
    libm.atan2f.argtypes = [ctypes.c_float, ctypes.c_float]
    rng = np.random.default_rng(0)
    y, x = rng.uniform(-1100, 1100, (2, 4000)).astype(np.float32)
    x[:8] = [0, -0.0, 1, -1, 0, 0, np.inf, -np.inf]
    y[:8] = [0, 0, 0, 0, 1, -1, 1, 1]
    want = np.array([libm.atan2f(float(a), float(b)) for a, b in zip(y, x)],
                    np.float32)
    np.testing.assert_array_equal(atan2f(y, x), want)
    got = T._atan2(torch.from_numpy(y), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_visual_field_needs_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.visual_field(*_one_eye(_circle(100, 0), np.zeros(40)))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_card_equals_cpu_but_at_bin_and_depth_edges():
    """The card's planes against the CPU path's on seeded scenes: every
    cell that departs has a deciding point within a few ulps of a bin or
    depth-level edge (chip_smoke.vf_departures)."""
    for seed, n_fish, n_points in ((0, 64, 256), (1, 200, 128)):
        inputs = chip_smoke.vf_scene(seed, n_fish, n_points)
        card = {k: v.cpu().numpy() for k, v in
                T.visual_field(*inputs, device="cuda").items()}
        cpu = {k: v.numpy() for k, v in
               T.visual_field(*inputs, device="cpu").items()}
        dep = chip_smoke.vf_departures(inputs, card, cpu)
        assert not dep["unexplained"], dep
