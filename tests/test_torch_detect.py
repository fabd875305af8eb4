"""The port's detection package (trex_tpu_torch/detect/) against the JAX
package's trex_tpu/detect/, on the CPU.

Host post-processing is held bit for bit: the tiling, GreedyNMM and NMS
over float32 and float64 rows, the prediction filter, region proposals,
the four blob converters, and `YOLODetector._postprocess` fed the same
decoded arrays for every task (and `detect_format points`). End to end,
`YOLODetector.detect` letterboxed and tiled runs both packages' own
letterbox and tiling, with the decoded rows of the port's model fed to
both (the model itself is held to flax in tests/test_torch_yolo.py): the
letterboxed canvases and every Detections array are equal.
`create_detection` builds every registry key and its blobs equal the JAX
backend's; `sam3` builds from a checkpoint and segments as the JAX
backend does."""
import numpy as np
import pytest
import torch

from test_yolo_checkpoint import TPose, TYolo8n, _randomize
from trex_tpu.config import Settings as JaxSettings
from trex_tpu.detect import base as jax_base
from trex_tpu.detect import prediction_filter as jax_pf
from trex_tpu.detect import region as jax_region
from trex_tpu.detect import tiling as jax_tiling
from trex_tpu.detect import yolo as jax_yolo
from trex_tpu_torch.config import Settings
from trex_tpu_torch.detect import base, prediction_filter, region, tiling
from trex_tpu_torch.detect import yolo as port_yolo


def pair(**values):
    j, p = JaxSettings(), Settings()
    for k, v in values.items():
        j.set(k, v)
        p.set(k, v)
    return j, p


def assert_detections_equal(a, b):
    for f in ("boxes", "conf", "clid", "keypoints", "masks", "obb",
              "points", "radii"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
            assert np.array_equal(x, y), f


def assert_blobs_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x.lines), np.asarray(y.lines))
        assert np.array_equal(x.pixels, y.pixels)
        assert x.flags == y.flags
        px, py = getattr(x, "prediction", None), getattr(y, "prediction",
                                                          None)
        assert (px is None) == (py is None)
        if px is not None:
            assert px["clid"] == py["clid"] and px["p"] == py["p"]
            assert (px["keypoints"] is None) == (py["keypoints"] is None)
            if px["keypoints"] is not None:
                assert np.array_equal(px["keypoints"], py["keypoints"])


# ---------------------------------------------------------------------------
# tiling and the greedy merges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame", [(1024, 1024), (1920, 1080), (640, 480),
                                   (333, 777), (0, 100)])
def test_tiling_equals_jax(frame):
    for det in ((640, 640), (320, 320), (0, 0)):
        for target in (0, 200, 640, 1000):
            for tiles in (0, 1, 2, 3):
                args = (frame, det, target, tiles)
                assert tiling.compute_tiling_dimensions(*args) == \
                    jax_tiling.compute_tiling_dimensions(*args)
                for overlap in (0.0, 0.1, 0.5, 0.99, -1.0):
                    assert tiling.compute_tile_bounds(*args, overlap) == \
                        jax_tiling.compute_tile_bounds(*args, overlap)
    for extent in (0, 5, 64, 1000):
        for tile in (0, 3, 64, 640):
            for stride in (1, 7, 64):
                assert tiling.compute_offsets(extent, tile, stride) == \
                    jax_tiling.compute_offsets(extent, tile, stride)


def random_rows(seed, n, dtype):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(0, 40, (n, 2))
    # duplicates from overlapping tiles: jittered copies of some rows
    dup = rng.integers(0, n, n // 3)
    xy = np.concatenate([xy, xy[dup] + rng.normal(0, 2, (len(dup), 2))])
    wh = np.concatenate([wh, wh[dup] * rng.uniform(0.8, 1.2,
                                                   (len(dup), 2))])
    boxes = np.concatenate([xy, xy + wh], 1).astype(dtype)
    boxes[::17, 2] = boxes[::17, 0]  # zero-area rows drop out
    conf = rng.uniform(0, 1, len(boxes)).astype(dtype)
    conf[5::11] = conf[4::11][:len(conf[5::11])]  # confidence ties
    clid = rng.integers(0, 3, len(boxes))
    return boxes, conf, clid


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_greedy_nmm_and_nms_equal_jax(seed, dtype):
    boxes, conf, clid = random_rows(seed, 120, dtype)
    for thr in (0.0, 0.3, 0.5, 0.7, 1.0):
        want = jax_tiling.compute_tile_merge_groups(boxes, conf, clid, thr)
        got = tiling.compute_tile_merge_groups(boxes, conf, clid, thr)
        assert [(g.representative_index, g.source_indices)
                for g in got] == [(g.representative_index,
                                   g.source_indices) for g in want]
        assert tiling.compute_tile_nms_indices(boxes, conf, clid, thr) \
            == jax_tiling.compute_tile_nms_indices(boxes, conf, clid, thr)
    assert tiling.compute_tile_nms_indices(boxes[:0], conf[:0], clid[:0],
                                           0.5) == []


def test_prediction_filter_equals_jax():
    classes = {0: "fish", 1: "Shark", 2: "eel"}
    for sv in ("[0,2]", "fish,eel", "-[shark]", "-1", "[]", "2", "+1"):
        a = prediction_filter.PredictionFilter.from_str(sv, classes)
        b = jax_pf.PredictionFilter.from_str(sv, classes)
        assert (a.detect_only, a.inverted_from, a.to_str(), bool(a)) == \
            (b.detect_only, b.inverted_from, b.to_str(), bool(b))
        assert [a.allowed(c) for c in range(4)] == \
            [b.allowed(c) for c in range(4)]
    with pytest.raises(ValueError):
        prediction_filter.PredictionFilter.from_str("whale", classes)
    for raw in ("", [], [1, "eel"], "[0]", "-[eel]"):
        j, p = pair(detect_only_classes=raw, detect_classes=classes)
        a = prediction_filter.filter_from_settings(p)
        b = jax_pf.filter_from_settings(j)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.to_str() == b.to_str()


def fake_detector(module, seed):
    """A deterministic detector of `module`'s Detections: boxes and
    keypoints drawn from the crop's size and sum."""
    def detect(img):
        rng = np.random.default_rng(seed + int(img.sum()) % 9973)
        h, w = img.shape[:2]
        n = int(rng.integers(0, 6))
        xy = rng.uniform(0, [w, h], (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], 1)
        kp = np.concatenate([rng.uniform(0, w, (n, 5, 1)),
                             rng.uniform(0, h, (n, 5, 1)),
                             rng.uniform(0, 1, (n, 5, 1))], -1)
        return module.Detections(boxes, rng.uniform(0, 1, n),
                                 rng.integers(0, 2, n), keypoints=kp)
    return detect


@pytest.mark.parametrize("pose_bbx", ["keypoints", "boxes"])
def test_region_proposal_equals_jax(pose_bbx):
    img = np.random.default_rng(0).integers(0, 256, (700, 900), np.uint8)
    j, p = pair(detect_pose_bbx=pose_bbx)
    for seed in range(5):
        want = jax_region.region_proposal_detect(
            img, fake_detector(jax_yolo, seed),
            fake_detector(jax_yolo, seed + 50), j, crop_size=160)
        got = region.region_proposal_detect(
            img, fake_detector(port_yolo, seed),
            fake_detector(port_yolo, seed + 50), p, crop_size=160)
        assert_detections_equal(got, want)
    boxes = np.random.default_rng(1).uniform(0, 300, (30, 4))
    boxes[:, 2:] = boxes[:, :2] + 20
    assert np.array_equal(region._merge_overlapping(boxes, 20.0),
                          jax_region._merge_overlapping(boxes, 20.0))


# ---------------------------------------------------------------------------
# blob converters and _postprocess
# ---------------------------------------------------------------------------

def random_detections(module, seed, h, w, n=12):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, [w, h], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(1, 40, (n, 2))], 1)
    obb = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n),
                    rng.uniform(1, 30, n), rng.uniform(1, 30, n),
                    rng.uniform(-np.pi, np.pi, n)], 1)
    obb[0, 4] = 0.0  # axis-aligned: scanlines through the corners
    det = module.Detections(boxes, rng.uniform(0, 1, n),
                            rng.integers(0, 3, n),
                            keypoints=rng.uniform(0, w, (n, 5, 3)),
                            obb=obb)
    det.points = rng.uniform(0, [w, h], (n, 2))
    det.radii = rng.uniform(0.5, 15, n)
    masks = rng.uniform(0, 1, (n, h // 2, w // 2)) > 0.7
    return det, masks


@pytest.mark.parametrize("only", ["", "[0,2]"])
def test_blob_converters_equal_jax(only):
    img = np.random.default_rng(3).integers(0, 256, (90, 120), np.uint8)
    j, p = pair(detect_only_classes=only)
    for seed in range(3):
        dj, mj = random_detections(jax_yolo, seed, 90, 120)
        dp, mp = random_detections(port_yolo, seed, 90, 120)
        assert_blobs_equal(port_yolo.boxes_to_blobs(dp, img, p),
                           jax_yolo.boxes_to_blobs(dj, img, j))
        assert_blobs_equal(port_yolo.masks_to_blobs(dp, img, mp, p),
                           jax_yolo.masks_to_blobs(dj, img, mj, j))
        assert_blobs_equal(port_yolo.obbs_to_blobs(dp, img, p),
                           jax_yolo.obbs_to_blobs(dj, img, j))
        assert_blobs_equal(port_yolo.points_to_blobs(dp, img, p),
                           jax_yolo.points_to_blobs(dj, img, j))
    assert np.array_equal(port_yolo.obb_corners(dp.obb),
                          jax_yolo.obb_corners(dj.obb))


def decoded_rows(seed, B, N, task, input_size):
    """Decoded model rows as the device hands them to the host."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, input_size, (B, N, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 20, (B, N, 2))], -1)
    out = {"boxes": boxes.astype(np.float32),
           "conf": rng.uniform(0, 1, (B, N)).astype(np.float32),
           "clid": rng.integers(0, 2, (B, N))}
    if task == "pose":
        out["keypoints"] = rng.uniform(0, input_size, (B, N, 5, 3)).astype(
            np.float32)
    if task == "segment":
        out["mask_coeffs"] = rng.normal(0, 1, (B, N, 8)).astype(np.float32)
        out["proto"] = rng.normal(0, 1, (B, input_size // 4,
                                         input_size // 4, 8)).astype(
            np.float32)
    if task == "obb":
        out["obb"] = np.concatenate(
            [xy, rng.uniform(2, 20, (B, N, 2)),
             rng.uniform(-1.5, 1.5, (B, N, 1))], -1).astype(np.float32)
    return out



def bare(module, settings, task, input_size=64):
    d = object.__new__(module.YOLODetector)
    d.settings, d.task, d.input_size = settings, task, input_size
    d._conf_threshold = float(settings["detect_conf_threshold"] or 0.1)
    d.points_mode = str(settings["detect_format"] or "") == "points"
    return d


@pytest.mark.parametrize("fmt", ["boxes", "points"])
@pytest.mark.parametrize("task", ["detect", "segment", "pose", "obb"])
def test_postprocess_equals_jax_on_the_same_decoded_rows(task, fmt):
    j, p = pair(detect_conf_threshold=0.4, detect_iou_threshold=0.5,
                detect_format=fmt)
    out = decoded_rows(7, 2, 300, task, 64)
    for k in range(2):
        for hw in ((64, 64), (48, 80), (100, 30)):
            got = bare(port_yolo, p, task)._postprocess(
                {a: b.copy() for a, b in out.items()}, k, hw)
            want = bare(jax_yolo, j, task)._postprocess(
                {a: b.copy() for a, b in out.items()}, k, hw)
            assert_detections_equal(got, want)


# ---------------------------------------------------------------------------
# YOLODetector end to end, and the registry
# ---------------------------------------------------------------------------

def scene(h, w, seed=0, color=False):
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 200, np.uint8)
    for _ in range(12):
        x, y = rng.integers(0, [w - 12, h - 8])
        img[y:y + 6, x:x + 12] = rng.integers(30, 120)
    if color:
        img = np.stack([img, 255 - img, img // 2], -1)
    return img


def shared_model(jdet, pdet):
    """Both detectors take the port model's decoded rows of the canvas
    each letterboxed itself; both canvases are recorded."""
    seen = {"jax": [], "port": []}
    pinfer = pdet._infer

    def jax_side(canvas):
        canvas = np.asarray(canvas).astype(np.uint8)
        seen["jax"].append(canvas)
        return pinfer(canvas)

    def port_side(canvas):
        seen["port"].append(canvas)
        return pinfer(canvas)

    jdet._infer, pdet._infer = jax_side, port_side
    return seen


def jax_detector(settings, task, input_size):
    """The JAX package's YOLODetector without its flax model, whose
    initialisation would compile the network: `shared_model` feeds it."""
    d = object.__new__(jax_yolo.YOLODetector)
    d.settings, d.task, d.input_size = settings, task, input_size
    d._conf_threshold = float(settings["detect_conf_threshold"] or 0.1)
    d.points_mode = str(settings["detect_format"] or "") == "points"
    d.batch_size = d._auto_batch_size()
    return d


@pytest.mark.parametrize("task", ["pose", "detect", "obb"])
@pytest.mark.parametrize("tiles", [0, 2])
def test_detector_equals_jax_letterboxed_and_tiled(task, tiles):
    j, p = pair(detect_tile_image=tiles, detect_tile_overlap=0.1,
                detect_batch_size=3, detect_conf_threshold=0.3)
    jdet = jax_detector(j, task, 64)
    pdet = port_yolo.YOLODetector(p, scale="n", task=task, num_classes=2,
                                  input_size=64, num_keypoints=5,
                                  device="cpu")
    assert pdet.batch_size == jdet.batch_size == 3
    seen = shared_model(jdet, pdet)
    for img in (scene(96, 128), scene(70, 50, 1, color=True)):
        assert_detections_equal(pdet.detect(img), jdet.detect(img))
    assert len(seen["port"]) == len(seen["jax"]) > 0
    # the JAX package pads a short last batch with zero images for its
    # fixed compiled shape; the port forwards the images it has
    for a, b in zip(seen["port"], seen["jax"]):
        assert np.array_equal(a, b[:len(a)])
        assert not b[len(a):].any()


def test_detector_runs_its_own_model_on_the_cpu():
    _, p = pair(detect_conf_threshold=0.0)
    det = port_yolo.YOLODetector(p, scale="n", task="pose", num_classes=1,
                                 input_size=64, num_keypoints=5,
                                 device="cpu")
    d = det.detect(scene(64, 96))
    assert len(d) > 0 and d.keypoints.shape[1:] == (5, 3)
    assert np.isfinite(d.boxes).all()
    dev = det.infer_device(np.zeros((2, 64, 64, 3), np.uint8))
    assert dev["boxes"].device.type == "cpu"


@pytest.fixture(scope="module")
def pose_pt(tmp_path_factory):
    """A 17-keypoint pose checkpoint: the JAX package's YOLOBackend
    builds its model with 17 keypoints whatever the checkpoint holds
    (the port's takes the checkpoint's count,
    test_yolo_backend_takes_the_checkpoints_keypoints)."""
    tm = TYolo8n(1)
    tm.model[22] = TPose(1, [64, 128, 256])
    _randomize(tm, seed=2)
    path = tmp_path_factory.mktemp("pt") / "pose.pt"
    torch.save({"model": tm.eval()}, path)
    return path


def test_create_detection_every_registry_key(tmp_path, pose_pt, monkeypatch):
    img = scene(96, 128, 3, color=True)
    bg = np.full((96, 128), 200, np.uint8)
    csv = tmp_path / "dets.csv"
    csv.write_text("x,y,w,h,frame\n10,12,20,8,0\n-5,40,30,9,0\n"
                   "120,90,30,30,0\n5,5,3,3,1\n")
    npz = tmp_path / "dets.npz"
    np.savez(npz, x=np.array([10.0, 60.5]), y=np.array([12.0, 30.0]),
             w=np.array([20.0, 9.0]), h=np.array([8.0, 4.0]),
             frame=np.array([0, 0]))
    cases = [dict(detect_type="none"),
             dict(detect_type="background_subtraction",
                  detect_threshold=15),
             dict(detect_type="precomputed",
                  detect_precomputed_file=str(csv)),
             dict(detect_type="precomputed",
                  detect_precomputed_file=str(npz)),
             dict(detect_type="yolo", detect_model=str(pose_pt),
                  detect_resolution=64, detect_conf_threshold=0.2),
             dict(detect_type="yolo", detect_model=str(pose_pt),
                  detect_resolution=64, detect_conf_threshold=0.2,
                  detect_tile_image=2, detect_tile_overlap=0.1,
                  detect_batch_size=8)]
    for values in cases:
        j, p = pair(**values)
        want = jax_base.create_detection(j, background=bg)
        got = base.create_detection(p, background=bg, device="cpu")
        assert type(got).__name__ == type(want).__name__
        if values["detect_type"] == "yolo":
            assert got.detector.task == "pose"
            shared_model(want.detector, got.detector)
        gray_in = img if values["detect_type"] != "background_subtraction" \
            else img[..., 1].copy()
        for frame in (0, 1):
            assert_blobs_equal(got.apply(frame, gray_in),
                               want.apply(frame, gray_in))
    assert set(base.REGISTRY) == set(jax_base.REGISTRY)
    sam3_backends_equal(tmp_path, monkeypatch, img)
    _, p = pair(detect_type="bogus")
    with pytest.raises(ValueError, match="unknown detect_type"):
        base.create_detection(p, device="cpu")


def sam3_backends_equal(tmp_path, monkeypatch, img):
    """sam3: both facades build their backend from one official-format
    checkpoint (a tiny SAM of tests/sam_torch_ref.py; ``from_checkpoint``
    builds ViT-B, so both packages' SAM classes take the tiny sizes and
    float32 here) and segment the same frames alike
    (tests/test_torch_sam3.py's rule)."""
    import test_torch_sam3 as T
    from sam_torch_ref import Sam as RefSam
    from sam_torch_ref import randomize
    from trex_tpu.models import sam as jax_sam
    from trex_tpu_torch.models import sam as port_sam

    ref = RefSam(img_size=128, dim=32, depth=2, heads=2, global_idx=(1,))
    randomize(ref, 5)
    path = tmp_path / "sam_tiny.pth"
    torch.save(ref.state_dict(), path)

    class JaxTiny(jax_sam.SAM):
        img_size: int = 128
        encoder_dim: int = 32
        encoder_depth: int = 2
        encoder_heads: int = 2
        global_idx: tuple = (1,)

    class PortTiny(port_sam.SAM):
        def __init__(self, dtype=None):
            super().__init__(**T.TINY, dtype=dtype)

    monkeypatch.setattr(jax_sam, "SAM", JaxTiny)
    monkeypatch.setattr(port_sam, "SAM", PortTiny)
    T._wrap_float32(monkeypatch, T.jax_sam3.SamSegmenter,
                    T.jnp.float32, True)
    T._wrap_float32(monkeypatch, T.sam3.SamSegmenter, torch.float32)
    prompt = "{0:[[10,12,60,50],[70,20,120,90]],1:[[0,0,127,95]]}"
    j, p = pair(detect_type="sam3", detect_model=str(path),
                detect_sam3_prompt=prompt)
    want = jax_base.create_detection(j)
    got = base.create_detection(p, device="cpu")
    assert type(got).__name__ == type(want).__name__ == "Sam3Backend"
    assert isinstance(got.segmenter.model, PortTiny)
    for frame in (0, 1):
        objs, jobjs = (b.prompts.materialize(frame) for b in (got, want))
        assert [(o.id, o.seed_box) for o in objs] \
            == [(o.id, o.seed_box) for o in jobjs]
        seen = {}
        segment = got.segmenter.segment
        got.segmenter.segment = lambda im, o: seen.setdefault(
            "masks", segment(im, o))
        blobs = got.apply(frame, img)
        del got.segmenter.segment
        masks, logits = T.jax_logits(want.segmenter, img, jobjs)
        T.assert_masks_agree(seen["masks"], masks, logits)
        T.assert_sam_blobs_equal(
            blobs, T.jax_sam3.blobs_from_masks(seen["masks"], img))
    _, p = pair(detect_type="sam3")
    with pytest.raises(ValueError, match="segment-anything checkpoint"):
        base.create_detection(p, device="cpu")


def test_yolo_backend_takes_the_checkpoints_keypoints(tmp_path):
    tm = TYolo8n(1)
    tm.model[22] = TPose(1, [64, 128, 256], nk=15)
    _randomize(tm, seed=4)
    path = tmp_path / "pose5.pt"
    torch.save({"model": tm.eval()}, path)
    _, p = pair(detect_type="yolo", detect_model=str(path),
                detect_resolution=64, detect_conf_threshold=0.0)
    got = base.create_detection(p, device="cpu")
    assert got.detector.model.num_keypoints == 5
    blobs = got.apply(0, scene(64, 64))
    assert blobs and blobs[0].prediction["keypoints"].shape == (5, 3)
