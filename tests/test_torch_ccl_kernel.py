"""The hand-written CUDA kernels of the labellers and their wrappers: the
union-find labeler ``trex_tpu_torch/csrc/ccl.cu`` and the 3x3 minimum
stencil ``trex_tpu_torch/csrc/neighbor_min.cu``. Imports neither JAX nor
trex_tpu, so the tests marked ``cuda`` run on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_ccl_kernel.py

and skip without one: a CUDA kernel has no CPU mode. The others check,
on the CPU, that the wrapper takes the plain version only for a CPU
tensor and that a missing compiler or a failed launch raises."""
import numpy as np
import pytest
import torch

import chip_smoke
from trex_tpu_torch import kernels
from trex_tpu_torch.ops import cc_device as T
from trex_tpu_torch.ops.device_pipeline import detect_batch


def _s_shape(h=64, w=96, turns=5):
    """A serpentine of `turns` bars joined alternately at the right and
    the left edge: one component that spans the frame."""
    m = np.zeros((h, w), np.uint8)
    ys = np.linspace(1, h - 2, turns).astype(int)
    for i, y in enumerate(ys):
        m[y, 1:w - 1] = 1
        if i + 1 < len(ys):
            x = w - 2 if i % 2 == 0 else 1
            m[y:ys[i + 1] + 1, x] = 1
    return m


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(["ccl"])


def test_failed_launch_raises():
    with pytest.raises(RuntimeError, match="failed with error 9"):
        kernels.check(9, "trex_ccl_label")


def test_wrapper_rejects_unbatched_mask():
    with pytest.raises(ValueError, match=r"\(B, H, W\)"):
        T.label_components_vmem(torch.zeros((4, 4), dtype=torch.bool))


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_cpu_tensor_takes_plain_version(dtype):
    """A CPU tensor runs the plain union-find, launches nothing and gives
    the min-propagation labels."""
    rng = np.random.default_rng(2)
    m = np.concatenate([rng.random((2, 40, 70)) < 0.45,
                        _s_shape(40, 70, 7)[None] > 0])
    mask = torch.as_tensor(m).to(dtype)
    before = kernels.launches["ccl"]
    got = T.label_components_vmem(mask)
    assert kernels.launches["ccl"] == before
    assert got.dtype == torch.int32
    assert torch.equal(got, T.label_components(mask))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.1, 0.35, 0.6])
def test_cuda_kernel_equals_plain(cuda_device, density):
    rng = np.random.default_rng(1)
    mask = torch.as_tensor(rng.random((3, 67, 130)) < density)
    before = kernels.launches["ccl"]
    got = T.label_components_vmem(mask.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launches["ccl"] == before + 1
    assert torch.equal(got.cpu(), T.label_components_plain(mask))


@pytest.mark.cuda
def test_cuda_kernel_serpentines(cuda_device):
    m = torch.as_tensor(np.stack([_s_shape(256, 333, 9),
                                  _s_shape(256, 333, 120)]))
    got = T.label_components_vmem(m.to(cuda_device)).cpu()
    assert torch.equal(got, T.label_components_plain(m))
    assert torch.equal(got, T.label_components(m))
    assert set(got[0].unique().tolist()) == {-1, 333 + 1}


@pytest.mark.cuda
def test_cuda_failed_launch_raises_and_counts_nothing(cuda_device,
                                                      monkeypatch):
    class Refused:
        @staticmethod
        def trex_ccl_scratch_ints(*args):
            return 1

        @staticmethod
        def trex_ccl_label(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(kernels, "library", lambda name: Refused)
    before = kernels.launches["ccl"]
    with pytest.raises(RuntimeError, match="failed with error 9"):
        T.label_components_vmem(torch.ones((1, 8, 8), dtype=torch.bool,
                                           device=cuda_device))
    assert kernels.launches["ccl"] == before


@pytest.mark.cuda
def test_cuda_detect_batch_equals_cpu(cuda_device):
    rng = np.random.default_rng(3)
    bg = np.full((96, 150), 200, np.uint8)
    frames = np.repeat(bg[None], 4, 0)
    for b in range(4):
        for _ in range(12):
            y, x = rng.integers(0, 88), rng.integers(0, 138)
            frames[b, y:y + rng.integers(2, 8), x:x + rng.integers(2, 12)] \
                = rng.integers(60, 170)
    kw = dict(threshold=15, track_threshold=40, absolute=False,
              max_blobs=64)
    got = detect_batch(frames, bg, use_pallas=True, device=cuda_device, **kw)
    ref = detect_batch(frames, bg, use_pallas=True, device="cpu", **kw)
    for k in ("valid", "count", "track_count"):
        assert torch.equal(got[k].cpu(), ref[k]), k
    v = ref["valid"]
    for k in ("cx", "cy"):
        assert torch.equal(got[k].cpu()[v], ref[k][v]), k


def test_stencil_cpu_tensor_takes_plain_version():
    rng = np.random.default_rng(4)
    tiles = torch.as_tensor(rng.integers(-50, 50, (2, 5, 7),
                                         dtype=np.int32))
    before = kernels.launches["neighbor_min"]
    got = T.neighbor_min(tiles)
    assert kernels.launches["neighbor_min"] == before
    assert torch.equal(got, T.neighbor_min_plain(tiles))
    # the wrap stays inside each frame
    one = torch.zeros((2, 3, 3), dtype=torch.int32)
    one[0, 0, 0] = -7
    assert torch.equal(T.neighbor_min(one)[1], one[1])
    assert bool((T.neighbor_min(one)[0] == -7).all())
    m = torch.as_tensor(_s_shape(40, 70, 7))
    assert torch.equal(T.label_components(m, use_pallas=True),
                       T.label_components(m))
    assert kernels.launches["neighbor_min"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 3), (3, 67, 130), (2, 1, 7),
                                   (1, 1026, 1026), (4, 35, 1000)])
def test_cuda_stencil_equals_plain(cuda_device, shape):
    rng = np.random.default_rng(list(shape))
    tiles = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, shape,
                                         dtype=np.int32))
    before = kernels.launches["neighbor_min"]
    got = T.neighbor_min(tiles.to(cuda_device))
    torch.cuda.synchronize()
    assert kernels.launches["neighbor_min"] == before + 1
    assert torch.equal(got.cpu(), T.neighbor_min_plain(tiles))


@pytest.mark.cuda
def test_cuda_label_components_use_pallas(cuda_device):
    rng = np.random.default_rng(5)
    m = torch.as_tensor(np.concatenate([
        rng.random((2, 96, 150)) < 0.4, _s_shape(96, 150, 11)[None] > 0]))
    before = kernels.launches["neighbor_min"]
    got = T.label_components(m.to(cuda_device), use_pallas=True).cpu()
    launched = kernels.launches["neighbor_min"] - before
    assert launched >= 11  # one per step; the serpentine needs its turns
    assert torch.equal(got, T.label_components(m))
    assert torch.equal(got, T.label_components_plain(m))


@pytest.mark.cuda
def test_cuda_stencil_failed_launch_raises(cuda_device, monkeypatch):
    class Refused:
        @staticmethod
        def trex_neighbor_min(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(kernels, "library", lambda name: Refused)
    before = kernels.launches["neighbor_min"]
    with pytest.raises(RuntimeError, match="failed with error 9"):
        T.neighbor_min(torch.zeros((1, 4, 4), dtype=torch.int32,
                                   device=cuda_device))
    assert kernels.launches["neighbor_min"] == before


_HARD_MASKS = chip_smoke.hard_masks()
_HARD_TILES = chip_smoke.hard_tiles()


@pytest.mark.cuda
@pytest.mark.parametrize("name,mask", _HARD_MASKS,
                         ids=[n for n, _ in _HARD_MASKS])
def test_cuda_kernel_hard_masks(cuda_device, name, mask):
    """Checkerboards, corner staircases, lines through every tile row,
    full and empty frames, H = 1, W = 1, every width mod 16 and frames of
    one tile."""
    m = torch.as_tensor(mask)
    got = T.label_components_vmem(m.to(cuda_device)).cpu()
    assert torch.equal(got, T.label_components_plain(m))
    if name == "all_foreground":
        assert bool((got == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name,tile,offset", _HARD_TILES,
                         ids=[n for n, _, _ in _HARD_TILES])
def test_cuda_stencil_hard_tiles(cuda_device, name, tile, offset):
    """Widths 0 .. 3 mod 4, a height below one strip, an unaligned view:
    the vector widths 2 and 1 of the same kernel."""
    t = chip_smoke.on_card(tile, cuda_device, offset)
    assert t.data_ptr() % 8 == (4 if offset else 0)
    before = kernels.launches["neighbor_min"]
    got = T.neighbor_min(t).cpu()
    assert kernels.launches["neighbor_min"] == before + 1
    assert torch.equal(got, T.neighbor_min_plain(torch.as_tensor(tile)))
