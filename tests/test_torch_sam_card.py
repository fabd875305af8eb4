"""The port's segmenter without the JAX package: its seeded random
model, a session over it on the CPU, and (marked ``cuda``, skipped
without a card) the segmenter on the card held to the CPU. This file
imports no JAX, so the card's machine runs it:

    python -m pytest --noconftest -m cuda tests/test_torch_sam_card.py
"""
import numpy as np
import pytest
import torch

from trex_tpu_torch.detect import sam3

MASK_MARGIN = 1e-3  # tests/test_torch_sam3.py's


def frame(shape, seed):
    """tests/test_torch_sam3.py's frames: dark noise with bright
    squares."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 60, shape).astype(np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
        img[y:y + 8, x:x + 8] = rng.integers(150, 255)
    return img


def test_small_random_is_seeded():
    a = sam3.SamSegmenter.small_random(
        img_size=64, generator=torch.Generator().manual_seed(4),
        device="cpu")
    b = sam3.SamSegmenter.small_random(img_size=64, seed=4, device="cpu")
    for (ka, ta), (kb, tb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    session = sam3.Sam3InteractiveSession(segment_fn=a.segment)
    session.add_prompt(0, sam3.Sam3Prompt(box=(10, 10, 40, 40)),
                       box=(10, 10, 40, 40))
    img = frame((48, 56), 1)
    session.propagate([0, 1], lambda f: img)
    assert session.state == sam3.SessionState.Ready
    mask = session.masks[1][1]
    assert mask.shape == img.shape and mask.dtype == bool


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the segmenter runs there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_segmenter_on_the_card_equals_the_cpu(cuda_device):
    """The same tiny float32 model on the card and on the CPU: the masks
    agree but for pixels whose CPU logit lies within MASK_MARGIN of the
    threshold."""
    cpu = sam3.SamSegmenter.small_random(img_size=128, seed=3,
                                         with_text=True, device="cpu")
    card = sam3.SamSegmenter.small_random(img_size=128, seed=3,
                                          with_text=True,
                                          device=cuda_device)
    assert next(card.model.parameters()).device.type == "cuda"
    img = frame((120, 96, 3), 2)
    objs = sam3.Sam3Prompts.from_setting(
        "{0:[[5,5,60,70],[30,40,90,110]],1:fish}").materialize(1)
    got, want = card.segment(img, objs), cpu.segment(img, objs)
    cpu.mask_threshold = MASK_MARGIN
    lo = cpu.segment(img, objs)
    cpu.mask_threshold = -MASK_MARGIN
    hi = cpu.segment(img, objs)
    assert list(got) == list(want)
    for oid in got:
        assert (lo[oid] <= got[oid]).all() and (got[oid] <= hi[oid]).all()
