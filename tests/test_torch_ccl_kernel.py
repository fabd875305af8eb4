"""The hand-written CUDA labeler (``trex_tpu_torch/csrc/ccl.cu``) and its
wrapper. Imports neither JAX nor trex_tpu, so the tests marked ``cuda``
run on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_ccl_kernel.py

and skip without one: a CUDA kernel has no CPU mode. The others check,
on the CPU, that the wrapper takes the plain version only for a CPU
tensor and that a missing compiler or a failed launch raises."""
import numpy as np
import pytest
import torch

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
