"""Several devices in the port (trex_tpu_torch/parallel/, sharded
detection, multi-video tracking, the dp x tp dryrun) against the JAX
package's mesh on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's collective-free sharding runs over 8 CPU places of one process
(``make_mesh(8, device="cpu")``), its ranks under gloo through
``parallel.launch``. Rank bodies live in tests/torch_parallel_ranks.py,
which imports no JAX: spawned ranks import it afresh.

Tolerance: detection tables, tracking histories and mesh shapes are
equal (``torch.equal`` / ``np.array_equal``). The dryrun's train step
against the single-device step on the global batch: loss, gathered
Dense gradients and updated Dense parameters within ``DRYRUN_TOL`` (1e-5
relative to each tensor's largest magnitude), float32 summed in another
order across ranks.
"""
import numpy as np
import pytest
import torch

import jax

from trex_tpu.config import reset_global_settings as jax_settings
from trex_tpu.ops import device_tracker as J
from trex_tpu.ops.runcc import detect_batch_runs_sharded as jax_sharded
from trex_tpu.parallel import make_mesh as jax_make_mesh
from trex_tpu.parallel import distributed as jax_dist
from trex_tpu.pipeline import DeviceDetector as JaxDeviceDetector
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.ops import device_tracker as T
from trex_tpu_torch.ops.runcc import (detect_batch_runs,
                                      detect_batch_runs_sharded)
from trex_tpu_torch.parallel import distributed, dryrun, mesh as pmesh
from trex_tpu_torch.pipeline import DeviceDetector

import torch_parallel_ranks as ranks
from test_torch_device_engine_automatic import crossing_frames
from test_torch_device_tracker import _render
from test_torch_runcc import _random_frames

DRYRUN_TOL = 1e-5
DET_KW = dict(detect_threshold=15, detect_absolute=False,
              track_threshold=20, track_absolute=False,
              max_runs=512, max_pixels=8192, max_blobs=128,
              max_child_runs=512, max_children=128)
TRACK_CAPS = dict(max_runs=512, max_pixels=8192, max_blobs=32,
                  max_child_runs=512, max_children=32)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
def test_make_mesh_shapes_equal_jax(axes):
    for n in range(1, 9):
        got = pmesh.make_mesh(n, axis_names=axes, device="cpu")
        want = jax_make_mesh(n, axis_names=axes)
        assert got.axis_names == want.axis_names
        assert got.shape == dict(want.shape)
        assert got.devices.shape == want.devices.shape
        assert all(d == torch.device("cpu") for d in got.devices.ravel())


def test_shard_batch_and_batch_slice_equal_jax():
    from trex_tpu.parallel import shard_batch as jax_shard_batch

    m, jm = pmesh.make_mesh(8, device="cpu"), jax_make_mesh(8)
    for n in (1, 5, 8, 13, 16):
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        shards, real = pmesh.shard_batch(m, x)
        arr, jreal = jax_shard_batch(jm, x)
        assert real == jreal == n and len(shards) == 8
        np.testing.assert_array_equal(torch.cat(shards).numpy(),
                                      np.asarray(arr))
    for b in (1, 8, 32, 33):
        assert distributed.process_batch_slice(b) \
            == jax_dist.process_batch_slice(b)
    assert pmesh.replicated(m).axis is None
    assert pmesh.batch_sharding(m).axis == "data"
    copies = pmesh.shard_params(m, {"w": np.ones(2)})
    assert list(copies) == [torch.device("cpu")]


def test_initialize_and_hybrid_mesh_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    assert jax_dist.initialize() is False
    got = distributed.hybrid_mesh(("data", "model"), model_axis_size=2,
                                  device="cpu", n_devices=8)
    want = jax_dist.hybrid_mesh(("data", "model"), model_axis_size=2)
    assert got.axis_names == want.axis_names
    assert got.shape == dict(want.shape)
    got1 = distributed.hybrid_mesh(("data",), device="cpu", n_devices=8)
    assert got1.shape == dict(jax_dist.hybrid_mesh(("data",)).shape)
    x = np.arange(32 * 4, dtype=np.float32).reshape(32, 4)
    np.testing.assert_array_equal(
        distributed.global_batch_array(got, x).numpy(), x)


def test_launch_gloo_ranks_initialize_and_gather():
    """Two gloo ranks: initialize() sees the group, the rank slices, the
    gathered global batch and the DeviceMesh over the ranks."""
    out = distributed.launch(ranks.probe, 2, "cpu")
    for r, o in enumerate(out):
        assert o["initialized"] and o["rank"] == r and o["world"] == 2
        assert o["slice"] == slice(16 * r, 16 * r + 16)
        np.testing.assert_array_equal(o["global"], np.arange(8) // 4 * 10
                                      + np.arange(8) % 4)
        assert o["mesh_names"] == ("data", "model")
        assert o["mesh_shape"] == (2, 1)


def test_a_group_built_outside_the_port_takes_the_cpu_only_if_named(
        tmp_path):
    """Two gloo ranks whose group the caller builds itself (as a torchrun
    script calling init_process_group would): gloo does not mean the
    CPU, so without CUDA the rank's device and the mesh of the ranks
    raise until the CPU is named; the trainer then trains there."""
    import torch.multiprocessing as mp

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the ranks' device is a card")
    mp.spawn(ranks.own_gloo_group, args=(2, str(tmp_path / "store"),
                                         str(tmp_path)), nprocs=2)
    for r in range(2):
        seen = torch.load(tmp_path / f"rank{r}.pt")
        assert "CUDA" in seen["rank_device"] and "CUDA" in \
            seen["hybrid_mesh"], seen
        assert seen["mesh_type"] == "cpu" and seen["device"] == "cpu"
        assert seen["dp"] == (r, 2) and seen["named"] == "cpu"


def test_launch_raises_a_rank_error_and_refuses_shared_nccl():
    with pytest.raises(Exception, match="rank 1 fails"):
        distributed.launch(ranks.fail_on_rank_one, 2, "cpu")
    with pytest.raises(ValueError, match="gloo"):
        distributed._backend(torch.device("cuda", 0), 2, None)
    with pytest.raises(ValueError, match="NCCL"):
        distributed._backend(torch.device("cpu"), 2, "nccl")
    assert distributed._backend(torch.device("cuda", 0), 2, "gloo") \
        == "gloo"


def test_detect_batch_runs_sharded_equals_jax_and_unsharded():
    rng = np.random.default_rng(2)
    bg, frames = _random_frames(rng, 8, 96, 128)
    got = detect_batch_runs_sharded(frames, bg,
                                    pmesh.make_mesh(8, device="cpu"),
                                    **DET_KW)
    single = detect_batch_runs(frames, bg, device="cpu", **DET_KW)
    want = _np(jax_sharded(frames, bg, jax_make_mesh(8), **DET_KW))
    for group in ("det", "child", "det_runs", "child_runs"):
        assert sorted(got[group]) == sorted(want[group])
        for k in got[group]:
            assert torch.equal(got[group][k], single[group][k]), (group, k)
            np.testing.assert_array_equal(got[group][k].numpy(),
                                          want[group][k])
    assert torch.equal(got["overflow"], single["overflow"])
    # a two-shard mesh on one place, and a batch that does not divide
    two = detect_batch_runs_sharded(frames, bg, pmesh.Mesh(
        ["cpu", "cpu"], ("data",)), **DET_KW)
    assert torch.equal(two["det"]["count"], single["det"]["count"])
    with pytest.raises(ValueError, match="does not split"):
        detect_batch_runs_sharded(frames[:5], bg, pmesh.make_mesh(
            8, device="cpu"), **DET_KW)


def _detector_settings(pkg_reset):
    s = pkg_reset()
    for k, v in dict(track_max_individuals=3, track_threshold=20,
                     track_threshold_is_absolute=False, detect_threshold=15,
                     detect_threshold_is_absolute=False,
                     track_size_filter=[[5, 400]], calculate_posture=False,
                     frame_rate=25, cm_per_pixel=1.0,
                     detect_batch_size=8).items():
        s.set(k, v)
    return s


def _blob_rows(blobs):
    return [[(np.asarray(b.lines).tolist(), np.asarray(b.pixels).tolist())
             for b in frame] for frame in blobs]


@pytest.mark.parametrize("n_images", [12, 3])
def test_device_detector_over_a_mesh_equals_one_place_and_jax(n_images):
    """tests/test_runcc.py::test_segmenter_device_engine_matches_host's
    scene through DeviceDetector over 8 CPU places, one place and the
    JAX detector over its 8 devices; 3 images pad a batch shorter than
    the mesh."""
    frames = []
    for f in range(n_images):
        img = np.full((96, 128), 200, np.uint8)
        for i in range(3):
            img[20 + 20 * i:26 + 20 * i, 10 + 30 * i + f:20 + 30 * i + f] \
                = 80
        frames.append(img)
    bg = np.full((96, 128), 200, np.uint8)
    mesh = pmesh.make_mesh(8, device="cpu")
    sharded = DeviceDetector(_detector_settings(reset_global_settings), bg,
                             mesh=mesh)
    assert sharded.batch_size == 8 and sharded.mesh is mesh
    one = DeviceDetector(_detector_settings(reset_global_settings), bg,
                         device="cpu")
    jd = JaxDeviceDetector(_detector_settings(jax_settings), bg)
    assert jd.mesh is not None
    got = _blob_rows(sharded.detect(frames))
    assert got == _blob_rows(one.detect(frames))
    assert got == _blob_rows(jd.detect(frames))
    assert sum(len(f) for f in got) == 3 * n_images


def _videos():
    """tests/test_device_tracker.py::test_multi_video_tracking_sharded_
    over_mesh's eight two-fish videos."""
    rng = np.random.default_rng(5)
    videos = []
    for v in range(8):
        pos = np.array([[30.0 + 20 * v % 60, 40.0],
                        [150.0, 100.0 + 10 * v]])
        vel = rng.normal(0, 1.0, (2, 2))
        fr = []
        for f in range(10):
            vel += rng.normal(0, 0.3, vel.shape)
            pos = np.clip(pos + vel, 10, 230)
            fr.append(_render(pos))
        videos.append(np.stack(fr))
    return np.stack(videos), np.full((256, 256), 200, np.uint8)


def _track_settings(pkg_reset, n_fish, **over):
    s = pkg_reset()
    d = dict(track_max_individuals=n_fish, track_max_speed=300,
             cm_per_pixel=1.0, frame_rate=25, track_threshold=20,
             track_threshold_is_absolute=False,
             track_background_subtraction=True,
             track_size_filter=[[10, 400]], calculate_posture=False,
             match_mode="approximate", track_do_history_split=False)
    d.update(over)
    for k, v in d.items():
        s.set(k, v)
    return s


def test_track_videos_sharded_equals_jax_and_per_video():
    batch, bg = _videos()
    ps = _track_settings(reset_global_settings, 2)
    got = T.track_videos_sharded(batch, bg, ps,
                                 mesh=pmesh.make_mesh(8, device="cpu"),
                                 **TRACK_CAPS)
    want = jax.device_get(J.track_videos_sharded(
        batch, bg, _track_settings(jax_settings, 2), mesh=jax_make_mesh(8),
        **TRACK_CAPS))
    keys = ("fish_seen", "fish_x", "fish_y", "n_assigned")
    for k in keys:
        assert got[k].shape[0] == 8
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["detect_overflow"].numpy(),
                                  np.asarray(want["detect_overflow"]))
    for v in range(8):
        solo = T.track_video_device(batch[v], bg, ps, device="cpu",
                                    **TRACK_CAPS)
        for k in keys:
            assert torch.equal(got[k][v], solo[k]), (v, k)
    # without a mesh every video runs on the one device
    flat = T.track_videos_sharded(batch[:2], bg, ps, device="cpu",
                                  **TRACK_CAPS)
    assert torch.equal(flat["fish_x"], got["fish_x"][:2])


def test_c11_sharded_videos_run_no_history_split_in_both_packages():
    """ROADMAP C11: with track_do_history_split on, track_videos_sharded
    passes no frames or split spec to the scan, so the frames where two
    fish merge are flagged needs_host, while track_video_device splits
    them on the device. Both packages do so, with equal flags."""
    bg, frames = crossing_frames()
    over = dict(match_mode="automatic", track_do_history_split=True,
                track_size_filter=[[10, 120]])
    ps = _track_settings(reset_global_settings, 2, **over)
    js = _track_settings(jax_settings, 2, **over)
    caps = dict(max_runs=1024, max_pixels=1 << 14, max_blobs=64,
                max_child_runs=1024, max_children=64)
    videos = np.stack([frames, frames])
    got = T.track_videos_sharded(videos, bg, ps, mesh=pmesh.make_mesh(
        2, device="cpu"), **caps)
    want = jax.device_get(J.track_videos_sharded(
        videos, bg, js, mesh=jax_make_mesh(2), **caps))
    solo = T.track_video_device(frames, bg, ps, device="cpu", **caps)
    jsolo = jax.device_get(J.track_video_device(frames, bg, js, **caps))
    flags = got["needs_host"][0].numpy()
    np.testing.assert_array_equal(flags, np.asarray(want["needs_host"])[0])
    np.testing.assert_array_equal(solo["needs_host"].numpy(),
                                  np.asarray(jsolo["needs_host"]))
    assert flags.sum() > solo["needs_host"].numpy().sum()


@pytest.mark.parametrize("n", [4, 2])
def test_dryrun_multichip_passes_its_three_checks(n):
    """dryrun_multichip(4): a 2x2 (data x model) mesh with column-
    parallel Dense layers; (2): data parallel only. Each rank's step
    equals the single-device step on the global batch within
    DRYRUN_TOL; detection and tracking are byte-equal inside."""
    out = dryrun.dryrun_multichip(n, device="cpu")
    assert out["mesh"] == ({"data": 2, "model": 2} if n == 4
                           else {"data": 2})
    assert out["loss_err"] <= DRYRUN_TOL
    assert out["grad_err"] <= DRYRUN_TOL
    assert out["param_err"] <= DRYRUN_TOL
    assert out["sharded_params"] > (0 if n == 4 else -1)
    assert out["detect_equal"] and out["track_equal"]


def test_entry_forward_shape():
    fn, args = dryrun.entry(device="cpu", batch=4)
    assert fn(*args).shape == (4, 100)
