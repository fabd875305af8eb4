"""The port's YOLOv8 (trex_tpu_torch/models/yolo.py) against the JAX
package's flax model, and the port's ultralytics `.pt` loader against
the JAX package's.

Every task (detect, segment, pose, obb) at scale n on 64x64 inputs: the
flax model's variables (drawn from a numpy seed in the shapes of its
initializer) carry across through
`state_from_flax`, and both compute the raw head maps and
`decode_predictions` of the same uint8-valued images. Tolerances:

- float32 (`dtype=float32` on both): raw maps within 1e-4 absolute,
  decoded rows within 1e-4 relative to their scale (boxes and keypoints
  in pixels up to 64). Both compute the same operations in float32;
  sums are taken in another order (XLA against oneDNN). Measured: at
  most 2e-7 on the raw maps, 6.1e-5 px on decoded boxes.
- bfloat16 (the default policy): raw maps within ROW_TOL (0.02) absolute
  and decoded scores within ROW_TOL. Both round activations to bfloat16
  after every 3x3 and 1x1 convolution, but XLA keeps fused elementwise
  chains in float32 where torch rounds after each operation, so single
  activations differ by a bfloat16 ulp or two. Measured: at most 0.0014
  on the raw maps and 1.5e-4 on scores.

The `.pt` loader: checkpoints written with the ultralytics-layout
modules of tests/test_yolo_checkpoint.py (detect, segment with the
learned `proto_up`, pose), loaded by both packages: the port's state
equals the JAX package's variables carried across, bit for bit, and the
metadata agree; a checkpoint whose classes cannot be imported loads
through the tolerant unpickler."""
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_yolo_checkpoint import (TPose, TSegment, TYolo8n,  # noqa: F401
                                  _randomize)
from trex_tpu.models.yolo import YOLOv8 as JaxYOLO
from trex_tpu.models.yolo import decode_predictions as jax_decode
from trex_tpu.models.yolo_convert import \
    load_ultralytics_checkpoint as jax_load
from trex_tpu_torch.models import yolo
from trex_tpu_torch.models.yolo_convert import load_ultralytics_checkpoint

F32_TOL = 1e-4
ROW_TOL = 0.02
TORCH_TOL = 2e-3
TASKS = ("detect", "segment", "pose", "obb")
HEADS = {"segment": "mask_coeffs", "pose": "keypoints", "obb": "angles"}


def seeded_variables(model, seed):
    """Variables of the flax model's shapes (``jax.eval_shape`` of its
    init, which compiles nothing) drawn from a numpy seed: kernels
    LeCun-normal, biases, BatchNorm scales and statistics away from the
    identity (which would hide a layout error)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "'kernel'" in name:
            fan_in = int(np.prod(a.shape[:-1]))
            x = rng.normal(0, 1 / np.sqrt(fan_in), a.shape)
        elif "'var'" in name:
            x = rng.uniform(0.5, 2.0, a.shape)
        elif "'mean'" in name:
            x = rng.normal(0, 0.2, a.shape)
        elif "'scale'" in name:
            x = rng.uniform(0.5, 1.5, a.shape)
        else:
            x = rng.normal(0, 0.1, a.shape)
        return jnp.asarray(x, jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def twin(task, dtype, seed=0, batch=2):
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = JaxYOLO(num_classes=3, scale="n", task=task, num_keypoints=5,
                 dtype=jdt)
    v = seeded_variables(jm, seed)
    img = np.random.default_rng(seed + 100).integers(
        0, 256, (batch, 64, 64, 3)).astype(np.float32)
    jo = jax.jit(jm.apply)(v, jnp.asarray(img))
    state = yolo.state_from_flax(v["params"], v["batch_stats"])
    pm = yolo.build(3, "n", task, num_keypoints=5, dtype=tdt, state=state,
                    device="cpu")
    with torch.no_grad():
        po = pm(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
        pd = yolo.decode_predictions(po, 3)
    return jo, jax_decode(jo, 3), po, pd


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("task", TASKS)
def test_raw_heads_and_decode_equal_flax(task, dtype):
    jo, jd, po, pd = twin(task, dtype)
    tol = F32_TOL if dtype == "float32" else ROW_TOL
    assert po["shapes"] == tuple(tuple(s) for s in jo["shapes"])
    keys = ["boxes", "classes"] + ([HEADS[task]] if task in HEADS else [])
    for k in keys:
        for a, b in zip(jo[k], po[k]):
            assert np.abs(np.asarray(a, np.float32) - _nhwc(b)).max() \
                <= tol, k
    if task == "segment":
        assert np.abs(np.asarray(jo["proto"], np.float32)
                      - _nhwc(po["proto"])).max() <= tol
    assert sorted(pd) == sorted(jd)
    for k in jd:
        want = np.asarray(jd[k], np.float64)
        got = pd[k].double().numpy()
        assert got.shape == want.shape, k
        if k == "clid":
            decided = np.sort(np.asarray(jd["scores"], np.float64), -1)
            gap = decided[..., -1] - decided[..., -2]
            assert (got == want)[gap > 2 * tol].all()
            continue
        # pixel rows (boxes, keypoints, obb) scale with the input
        scale = 64.0 if k in ("boxes", "keypoints", "obb") else 1.0
        if dtype == "bfloat16" and scale > 1:
            continue  # a box edge is a softmax expectation over bins
        assert np.abs(got - want).max() <= tol * scale, k


def test_bfloat16_policy_rounds_like_flax():
    """The bfloat16 model departs from its float32 self as flax's does:
    the policy is not float32 in disguise."""
    jo16, _, po16, _ = twin("pose", "bfloat16")
    jo32, _, po32, _ = twin("pose", "float32")
    j = np.abs(np.asarray(jo16["boxes"][0], np.float32)
               - np.asarray(jo32["boxes"][0], np.float32)).max()
    p = np.abs(_nhwc(po16["boxes"][0]) - _nhwc(po32["boxes"][0])).max()
    assert j > 1e-4 and p > 1e-4
    assert p < 10 * j and j < 10 * p


def test_state_from_flax_names_every_parameter():
    for task in TASKS:
        jm = JaxYOLO(num_classes=2, scale="n", task=task, num_keypoints=5)
        v = seeded_variables(jm, 1)
        state = yolo.state_from_flax(v["params"], v["batch_stats"])
        pm = yolo.YOLOv8(2, "n", task, num_keypoints=5)
        assert sorted(state) == sorted(pm.state_dict()), task
        yolo.load_state(pm, state)


def test_random_init_is_seeded_and_finite():
    a = yolo.build(1, "n", "pose", num_keypoints=5, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    b = yolo.build(1, "n", "pose", num_keypoints=5, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    with torch.no_grad():
        d = yolo.decode_predictions(a(torch.zeros(1, 3, 64, 64)), 1)
    assert d["keypoints"].shape == (1, 84, 5, 3)
    assert all(torch.isfinite(t).all() for t in d.values()
               if t.dtype.is_floating_point)


def _write(tmp_path, task, name):
    nc = {"detect": 9, "segment": 5, "pose": 2}[task]
    tm = TYolo8n(nc)
    if task == "segment":
        tm.model[22] = TSegment(nc, [64, 128, 256])
    elif task == "pose":
        tm.model[22] = TPose(nc, [64, 128, 256])
    _randomize(tm, seed=len(task))
    tm.eval()
    path = tmp_path / name
    torch.save({"model": tm}, path)
    return path, tm


@pytest.mark.parametrize("task", ["detect", "segment", "pose"])
def test_pt_loader_equals_jax_loader(tmp_path, task):
    path, tm = _write(tmp_path, task, f"yolov8n_{task}.pt")
    want = jax_load(path)
    got = load_ultralytics_checkpoint(path, device="cpu")
    for k in ("num_classes", "task", "scale", "num_keypoints", "kpt_dims"):
        assert got.get(k) == want.get(k), k
    carried = yolo.state_from_flax(want["params"], want["batch_stats"])
    assert sorted(got["state"]) == sorted(carried)
    for k, v in carried.items():
        assert np.array_equal(got["state"][k].numpy(), v), k
    # and the port's model on that state computes the torch modules'
    # forward (float32 throughout) within tests/test_yolo_checkpoint.py's
    # 2e-3: the layout's BatchNorm2d keeps torch's epsilon 1e-5, the
    # model ultralytics' 1e-3
    img = np.random.default_rng(4).integers(0, 256, (1, 64, 64, 3))
    x = torch.from_numpy(img.transpose(0, 3, 1, 2).astype(np.float32))
    pm = yolo.build(got["num_classes"], "n", got["task"],
                    num_keypoints=got.get("num_keypoints", 17),
                    dtype=torch.float32, state=got["state"], device="cpu")
    with torch.no_grad():
        ref = tm(x / 255.0)
        out = pm(x)
    det = ref[0] if task != "detect" else ref
    for lvl in range(3):
        assert torch.allclose(out["boxes"][lvl], det[lvl][0], atol=TORCH_TOL)
        assert torch.allclose(out["classes"][lvl], det[lvl][1], atol=TORCH_TOL)
    if task == "segment":
        assert torch.allclose(out["proto"], ref[2], atol=TORCH_TOL)
        for lvl in range(3):
            assert torch.allclose(out["mask_coeffs"][lvl], ref[1][lvl],
                                  atol=TORCH_TOL)
    if task == "pose":
        for lvl in range(3):
            assert torch.allclose(out["keypoints"][lvl], ref[1][lvl],
                                  atol=TORCH_TOL)


def test_pt_loader_tolerates_classes_it_cannot_import(tmp_path):
    """A checkpoint pickled with classes of a package that is not
    installed (as an ultralytics `.pt` names `ultralytics.nn...`) loads
    through the stubs, as in the JAX package."""
    fake = types.ModuleType("ultralytics_stub_layout")
    classes = {}
    import test_yolo_checkpoint as layout

    for name in ("TConv", "TBottleneck", "TC2f", "TSPPF", "TDetect",
                 "TPose", "TYolo8n"):
        cls = type(name, (getattr(layout, name),),
                   {"__module__": fake.__name__})
        setattr(fake, name, cls)
        classes[name] = cls
    sys.modules[fake.__name__] = fake
    try:
        tm = TYolo8n(2)
        tm.model[22] = TPose(2, [64, 128, 256])
        for m in tm.modules():
            for base, cls in classes.items():
                if type(m).__name__ == base:
                    m.__class__ = cls
        _randomize(tm, seed=9)
        path = tmp_path / "stubbed.pt"
        torch.save({"model": tm}, path)
    finally:
        del sys.modules[fake.__name__]
    want = jax_load(path)
    got = load_ultralytics_checkpoint(path, device="cpu")
    assert got["task"] == want["task"] == "pose"
    carried = yolo.state_from_flax(want["params"], want["batch_stats"])
    for k, v in carried.items():
        assert np.array_equal(got["state"][k].numpy(), v), k
