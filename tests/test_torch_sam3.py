"""The port's promptable segmentation (trex_tpu_torch/detect/sam3.py and
the sam3 backend of detect/base.py) against the JAX package's, on the
CPU.

- The prompt types, their string format, the prompt map, the prompt
  state and both sessions: every vector of tests/test_sam3.py (the
  reference's test_sam3promptpayload / test_sam3interactivesession
  coverage) runs on each package.
- The float32 ``INTER_LINEAR`` of `tag_image.resize_linear` against
  cv2 5.0.0 bit for bit under hypothesis: up, down, exact halvings, odd
  sizes, 1-pixel sides. OpenCV's IPP layer takes the call when both
  source sides are at least 2 (a lerp with one fused multiply-add);
  its own float path takes the rest.
- `SamSegmenter.segment` and `blobs_from_masks` end to end against the
  JAX package's (cv2 resizes there) on a tiny float32 SAM with the
  text tower, box and text prompts, gray and colour frames: the masks'
  decisions agree wherever the JAX package's logit lies further than
  MASK_MARGIN (1e-3) from ``mask_threshold``, and the blobs of the same
  masks are equal.
- `create_detection(detect_type="sam3")` on an official-format ViT-B
  checkpoint the test writes, one 1024^2 frame: both packages'
  ``from_checkpoint`` are wrapped to build float32 (they build
  bfloat16), and the masks are held as above. The JAX package's wrapper
  also hands its segmenter jax arrays: as it stands, its
  ``from_checkpoint`` keeps the converter's numpy arrays, which its
  jitted encoder cannot index with a traced index.
"""
import inspect
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_sam3
import trex_tpu.detect.sam3 as jax_sam3
from test_torch_sam import seeded_variables
from trex_tpu.config import Settings as JaxSettings
from trex_tpu.detect import base as jax_base
from trex_tpu.models import sam as J
from trex_tpu_torch.config import Settings
from trex_tpu_torch.detect import base, sam3
from trex_tpu_torch.models import sam as P
from trex_tpu_torch.track import tag_image as ti

MASK_MARGIN = 1e-3
TINY = dict(img_size=128, encoder_dim=32, encoder_depth=2, encoder_heads=2,
            global_idx=(1,))
HYP = settings(max_examples=200, deadline=None, derandomize=True,
               suppress_health_check=[HealthCheck.too_slow])

# the vectors of tests/test_sam3.py that need no model
VECTORS = sorted(
    name for name, fn in vars(test_sam3).items()
    if name.startswith("test_") and inspect.isfunction(fn)
    and name not in ("test_sam_segmenter_end_to_end",
                     "test_sam_checkpoint_conversion_roundtrip"))


@pytest.mark.parametrize("package", ["jax", "port"])
@pytest.mark.parametrize("name", VECTORS)
def test_sam3_vectors_on_both_packages(name, package, monkeypatch):
    """The vector runs with ``trex_tpu.detect.sam3`` bound to the package
    under test: its own imports and tests/test_sam3.py's module-level
    names both resolve there."""
    mod = jax_sam3 if package == "jax" else sam3
    monkeypatch.setitem(sys.modules, "trex_tpu.detect.sam3", mod)
    for attr in ("Sam3InteractiveSession", "Sam3Prompt", "Sam3Prompts",
                 "SessionState"):
        monkeypatch.setattr(test_sam3, attr, getattr(mod, attr))
    getattr(test_sam3, name)()


# ---------------------------------------------------------------------------
# the float32 resize
# ---------------------------------------------------------------------------

@st.composite
def float_resize_cases(draw):
    h, w = draw(st.integers(1, 70)), draw(st.integers(1, 70))
    kind = draw(st.sampled_from(["any", "halve", "double", "same"]))
    if kind == "halve":
        dh, dw = max(1, h // 2), max(1, w // 2)
    elif kind == "double":
        dh, dw = 2 * h, 2 * w
    elif kind == "same":
        dh, dw = h, w
    else:
        dh, dw = draw(st.integers(1, 140)), draw(st.integers(1, 140))
    rng = np.random.default_rng(draw(st.integers(0, 2**31)))
    scale = draw(st.sampled_from([1e-3, 1.0, 30.0, 1e6]))
    img = (rng.normal(size=(h, w)) * scale).astype(np.float32)
    if draw(st.booleans()):  # mask logits: runs of equal values, zeros
        img[rng.random(img.shape) < 0.3] = 0.0
    return img, (dw, dh)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@HYP
@given(float_resize_cases())
def test_float_resize_linear_bit_for_bit(case):
    img, size = case
    assert np.array_equal(_bits(ti.resize_linear(img, size)),
                          _bits(cv2.resize(img, size)))


@pytest.mark.parametrize("src,dst", [((256, 256), (1024, 1024)),
                                     ((1024, 1024), (1024, 1024)),
                                     ((960, 1024), (1080, 1152)),
                                     ((32, 32), (1080, 1920)),
                                     ((1, 9), (4, 17)), ((9, 1), (3, 1))])
def test_float_resize_linear_segment_sizes(src, dst):
    """The masks' sizes (256 -> 1024, the crop back to the frame) and the
    luminance map's (32 cells to a video frame); a stack goes through in
    one call."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    imgs = (rng.normal(size=(3,) + src) * 8).astype(np.float32)
    size = (dst[1], dst[0])
    got = ti._resize_linear_f32(imgs, size)
    for k in range(3):
        assert np.array_equal(_bits(got[k]), _bits(cv2.resize(imgs[k], size)))
        assert np.array_equal(_bits(got[k]),
                              _bits(ti.resize_linear(imgs[k], size)))


def test_resize_linear_refuses_other_types():
    with pytest.raises(ValueError, match="8-bit"):
        ti.resize_linear(np.zeros((4, 4), np.float64), (2, 2))
    with pytest.raises(ValueError, match="8-bit"):
        ti.resize_linear(np.zeros((4, 4, 3), np.float32), (2, 2))


# ---------------------------------------------------------------------------
# the segmenter against the JAX package's
# ---------------------------------------------------------------------------

def jax_logits(jseg, image, objs):
    """The JAX segmenter's masks and, per object id, the logits they
    threshold at full size: its decoded low-resolution masks, the one
    it picks, resized as it resizes them (the port's float32
    `resize_linear`, cv2's to the bit)."""
    seen = []
    calls = {}
    for attr in ("_decode", "_decode_text"):
        fn = getattr(jseg, attr)
        if fn is not None:
            calls[attr] = fn
            setattr(jseg, attr,
                    lambda *a, fn=fn: seen.append(fn(*a)) or seen[-1])
    try:
        with jax.default_matmul_precision("float32"):
            masks = jseg.segment(image, objs)
    finally:
        for attr, fn in calls.items():
            setattr(jseg, attr, fn)
    H, W = image.shape[:2]
    size = jseg.model.img_size
    scale = size / max(H, W)
    nh, nw = int(round(H * scale)), int(round(W * scale))
    low = []
    for m, iou in seen:
        m, iou = np.asarray(m), np.asarray(iou)
        best = 1 + iou[:, 1:].argmax(1)
        low.extend(m[np.arange(len(m)), best])
    up = ti._resize_linear_f32(np.stack(low), (size, size))[:, :nh, :nw]
    full = ti._resize_linear_f32(up, (W, H))
    return masks, dict(zip(masks, full))


def assert_masks_agree(got, want, logits, threshold=0.0):
    assert list(got) == list(want)
    near = 0
    for oid, m in got.items():
        assert m.dtype == bool and m.shape == want[oid].shape
        assert np.array_equal(want[oid], logits[oid] > threshold)
        clear = np.abs(logits[oid] - threshold) > MASK_MARGIN
        assert np.array_equal(m[clear], want[oid][clear]), oid
        near += int((~clear).sum())
    return near


def assert_sam_blobs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.lines, y.lines)
        assert np.array_equal(x.pixels, y.pixels)
        assert x.prediction == y.prediction


@pytest.fixture(scope="module")
def tiny_pair():
    jm = J.SAM(**TINY, dtype=jnp.float32, with_text=True)
    v = seeded_variables(jm, 2, 128, with_text=True)
    jseg = jax_sam3.SamSegmenter(jm, v)
    pseg = sam3.SamSegmenter(P.SAM(**TINY, dtype=torch.float32,
                                   with_text=True),
                             P.state_from_flax(v), device="cpu")
    return jseg, pseg


def frame(shape, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, shape).astype(np.uint8)
    for _ in range(6):  # bright blobs for the masks to find
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        img[y:y + 8, x:x + 8] = rng.integers(150, 255)
    return img


@pytest.mark.parametrize("shape,prompt", [
    ((96, 120), "{0:[[10,12,40,50],[60,20,100,90],[0,0,119,95]]}"),
    ((100, 80, 3), "{0:[[5,5,60,70]],1:fish,2:[[30,30,31,31]]}"),
    ((64, 64), "{0:['a guppy',[[1,1,20,20]]],3:fish}"),
    ((256, 200), "{0:[[10,20,150,240],[100,100,190,250]]}")])
def test_segment_and_blobs_equal_jax(tiny_pair, shape, prompt):
    jseg, pseg = tiny_pair
    prompts = sam3.Sam3Prompts.from_setting(prompt)
    jprompts = jax_sam3.Sam3Prompts.from_setting(prompt)
    img = frame(shape, sum(shape))
    near = total = 0
    for f in (0, 1, 3):
        objs, jobjs = prompts.materialize(f), jprompts.materialize(f)
        assert [o.id for o in objs] == [o.id for o in jobjs]
        got = pseg.segment(img, objs)
        want, logits = jax_logits(jseg, img, jobjs)
        assert len(got) == len(objs)
        near += assert_masks_agree(got, want, logits)
        total += len(got) * img.shape[0] * img.shape[1]
        assert_sam_blobs_equal(sam3.blobs_from_masks(got, img),
                               jax_sam3.blobs_from_masks(got, img))
    # the random model's logits lie within a few tenths of the
    # threshold; the margin spares under 1% of the pixels
    assert near <= 0.01 * total


def test_segmenter_threshold_and_empty_prompts(tiny_pair):
    jseg, pseg = tiny_pair
    img = frame((72, 90), 5)
    assert pseg.segment(img, []) == {} == jseg.segment(img, [])
    objs = sam3.Sam3Prompts.from_setting("{0:[[5,5,50,60]]}").materialize(0)
    jobjs = jax_sam3.Sam3Prompts.from_setting(
        "{0:[[5,5,50,60]]}").materialize(0)
    for thr in (-0.5, 0.25):
        pseg.mask_threshold = jseg.mask_threshold = thr
        want, logits = jax_logits(jseg, img, jobjs)
        assert_masks_agree(pseg.segment(img, objs), want, logits, thr)
    pseg.mask_threshold = jseg.mask_threshold = 0.0


def _wrap_float32(monkeypatch, cls, dtype, jax_arrays=False):
    """`cls.from_checkpoint` building in float32 (it builds bfloat16).
    `jax_arrays`: the JAX package's segmenter gets its variables as jax
    arrays: its converter returns numpy arrays, and its jitted encoder
    cannot index a numpy table with a traced index (``_rel_pos``), so
    ``from_checkpoint`` as it stands fails at the first frame."""
    orig = cls.from_checkpoint.__func__

    def from_checkpoint(c, path, **kw):
        kw["dtype"] = dtype
        seg = orig(c, path, **kw)
        if jax_arrays:
            seg = c(seg.model, jax.tree_util.tree_map(jnp.asarray,
                                                      seg.variables))
        return seg

    monkeypatch.setattr(cls, "from_checkpoint", classmethod(from_checkpoint))


def test_create_detection_sam3_vit_b_equals_jax(tmp_path, monkeypatch):
    """A random ViT-B in the official layout, written by the port's
    inverse converter; one 1024^2 frame with three box prompts through
    both facades."""
    state = P.build(dtype=torch.float32, device="cpu",
                    generator=torch.Generator().manual_seed(0)).state_dict()
    path = tmp_path / "sam_vit_b.pth"
    torch.save(P.official_state_dict(state), path)
    del state
    _wrap_float32(monkeypatch, jax_sam3.SamSegmenter, jnp.float32, True)
    _wrap_float32(monkeypatch, sam3.SamSegmenter, torch.float32)
    prompt = "{0:[[100,120,300,380],[500,500,700,650],[40,900,90,1000]]}"
    j, p = JaxSettings(), Settings()
    for s in (j, p):
        s.set("detect_type", "sam3")
        s.set("detect_model", str(path))
        s.set("detect_sam3_prompt", prompt)
    want = jax_base.create_detection(j)
    got = base.create_detection(p, device="cpu")
    assert isinstance(got, base.Sam3Backend)
    assert got.segmenter.model.dtype == torch.float32
    assert next(got.segmenter.model.parameters()).device.type == "cpu"
    img = frame((1024, 1024), 7)
    seen = {}
    segment = got.segmenter.segment
    got.segmenter.segment = lambda im, o: seen.setdefault(
        "masks", segment(im, o))
    blobs = got.apply(0, img)
    jmasks, logits = jax_logits(want.segmenter, img,
                                want.prompts.materialize(0))
    assert_masks_agree(seen["masks"], jmasks, logits)
    assert_sam_blobs_equal(blobs,
                           jax_sam3.blobs_from_masks(seen["masks"], img))


def test_sam3_backend_refusals():
    j, p = JaxSettings(), Settings()
    for s in (j, p):
        s.set("detect_type", "sam3")
        s.set("detect_model", "/nonexistent/sam.pth")
    with pytest.raises(ValueError) as want:
        jax_base.create_detection(j)
    with pytest.raises(ValueError) as got:
        base.create_detection(p, device="cpu")
    assert str(got.value) == str(want.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            base.create_detection(p)
