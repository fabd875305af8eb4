"""The arena border (trex_tpu_torch/track/border.py) against the JAX
package's with tolerance 0: ``recognition_border`` outline (the largest
dark region of the background, its every-point contour, the elliptic
Fourier smoothing, fillPoly and the elliptic shrink) and heatmap (the
blob-count grid from a ``.pv``, its box blur and the shrink), each mask
and the BORDER_DISTANCE it gives, with and without OpenCV in the port.
The port's image operations are its own copies of OpenCV's."""
import sys

import numpy as np
import pytest

from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.io.pv import PVFile as JaxPVFile
from trex_tpu.io.pv import PVFrame, PVHeader
from trex_tpu.track.border import Border as JaxBorder
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io.pv import PVFile
from trex_tpu_torch.track.border import Border


def _both(values):
    s, js = reset_global_settings(), jax_reset()
    for k, v in values.items():
        s.set(k, v)
        js.set(k, v)
    return s, js


def _arena(h, w, seed, edge=False):
    """A jagged dark arena on a bright background; with `edge` it runs
    past the frame on two sides."""
    rng = np.random.default_rng(seed)
    bg = np.full((h, w), 230, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = (h * 0.2, w * 0.85) if edge else (h / 2, w / 2)
    r = np.hypot(yy - cy, xx - cx)
    ang = np.arctan2(yy - cy, xx - cx)
    wobble = rng.uniform(4, 12) * np.sin(ang * int(rng.integers(5, 19)))
    bg[r < min(h, w) * (0.55 if edge else 0.38) + wobble] = 40
    bg[rng.random((h, w)) < 0.01] = 120
    return bg


def _probe(b, h, w):
    pts = [(x, y) for y in range(0, h, 7) for x in range(0, w, 9)]
    return [b.distance(x + 0.5, y + 0.25) for x, y in pts], \
        [b.in_recognition_bounds(x, y) for x, y in pts]


OUTLINE = [dict(), dict(recognition_coeff=8), dict(recognition_coeff=0),
           dict(recognition_smooth_amount=0),
           dict(recognition_border_shrink_percent=0.0),
           dict(recognition_border_shrink_percent=0.8,
                recognition_coeff=20)]


@pytest.mark.parametrize("case", range(len(OUTLINE)))
@pytest.mark.parametrize("edge", [False, True])
def test_outline_border_equals_jax(case, edge):
    h, w = 180, 230
    bg = _arena(h, w, case, edge)
    s, js = _both(dict(OUTLINE[case], recognition_border="outline"))
    b, jb = Border(s, bg), JaxBorder(js, bg)
    np.testing.assert_array_equal(b._mask, jb._mask)
    assert 0 < b._mask.sum() < h * w
    assert _probe(b, h, w) == _probe(jb, h, w)


def _heatmap_pv(path, bg, seed, n=40):
    """Fish-sized blobs wandering one region of the frame."""
    rng = np.random.default_rng(seed)
    h, w = bg.shape
    header = PVHeader(encoding="gray", width=w, height=h, average=bg,
                      name="h")
    with JaxPVFile.create(path, header) as pv:
        for i in range(n):
            fr = PVFrame(timestamp=(i + 1) * 40000, index=i)
            for _ in range(3):
                y = int(rng.integers(10, h // 2))
                x = int(rng.integers(10, w - 30))
                lines = np.stack([np.arange(y, y + 6), np.full(6, x),
                                  np.full(6, x + 9)], 1).astype(np.int32)
                fr.add_object(lines, np.full(6 * 10, 60, np.uint8))
            pv.add_frame(fr)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_heatmap_border_equals_jax(tmp_path, seed):
    bg = np.full((150, 210), 200, np.uint8)
    _heatmap_pv(tmp_path / "h.pv", bg, seed)
    s, js = _both(dict(recognition_border="heatmap", track_threshold=10,
                       track_threshold_is_absolute=False,
                       track_background_subtraction=True,
                       track_size_filter=[[10, 400]], cm_per_pixel=1.0,
                       recognition_border_shrink_percent=0.1 * seed))
    b, jb = Border(s, bg), JaxBorder(js, bg)
    b.update_from_video(PVFile.open(tmp_path / "h.pv"))
    jb.update_from_video(JaxPVFile.open(tmp_path / "h.pv"))
    np.testing.assert_array_equal(b._mask, jb._mask)
    assert 0 < b._mask.sum() < bg.size
    assert _probe(b, *bg.shape) == _probe(jb, *bg.shape)


def test_outline_border_without_opencv(monkeypatch):
    """With cv2 blocked the port's border still smooths, fills and
    shrinks: the same mask as the JAX package's with cv2."""
    h, w = 160, 200
    bg = _arena(h, w, 9)
    s, js = _both(dict(recognition_border="outline"))
    want = JaxBorder(js, bg)._mask
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(Border(s, bg)._mask, want)
