"""The port's TIFF decoder (trex_tpu_torch/io/image_decode.py with
native/tiffcodec.cpp) against ``cv2.imread`` of OpenCV 5.0.0 (libtiff
4.7, every 8-bit result through ``TIFFReadRGBA*``) under
``IMREAD_GRAYSCALE`` and ``IMREAD_COLOR``, bit for bit, the port's call
made with cv2 blocked: every file ``cv2.imwrite`` writes (compression 1,
5, 8 and 32773; predictor 1 and 2; 8- and 16-bit grey; 8- and 16-bit BGR
and BGRA), and under hypothesis files built here for what cv2 does not
write: either byte order, strips of any height and tiles (those cut by
the right edge included, which libtiff's grey tile readers step
wrongly), Palette at 1, 4 and 8 bits with 8- and 16-bit colour maps,
MinIsWhite, 1-bit grey, associated, unassociated and unspecified alpha,
grey with alpha, old-style LZW; a two-page file (the first page). Each
refused variant is named from its header, raises without OpenCV and
decodes through it where it is installed. Tolerance 0."""
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import trex_tpu_torch.io.video as port_video
from chip_smoke import wo_tiff_bytes
from test_torch_jpeg import (assert_decodes_as_cv2, assert_routes_to_opencv,
                             no_cv2)
from trex_tpu_torch.io import image_decode as dec

COMPRESSIONS = (1, 5, 8, 32773)
# (photometric, bits, samples, extra samples) of the files built here
KINDS = {
    "grey1": (1, 1, 1, None), "white1": (0, 1, 1, None),
    "grey8": (1, 8, 1, None), "white8": (0, 8, 1, None),
    "grey16": (1, 16, 1, None), "white16": (0, 16, 1, None),
    "grey_alpha8": (1, 8, 2, 2), "grey_alpha8_assoc": (1, 8, 2, 1),
    "grey_extra8": (1, 8, 2, 0), "grey_alpha16": (1, 16, 2, 2),
    "rgb8": (2, 8, 3, None), "rgb16": (2, 16, 3, None),
    "rgba8_unassoc": (2, 8, 4, 2), "rgba8_assoc": (2, 8, 4, 1),
    "rgba8_unspecified": (2, 8, 4, 0), "rgba8_no_tag": (2, 8, 4, None),
    "rgba16_unassoc": (2, 16, 4, 2), "rgba16_assoc": (2, 16, 4, 1),
    "palette1": (3, 1, 1, None), "palette4": (3, 4, 1, None),
    "palette8": (3, 8, 1, None),
}


def _cv2_written(path, img, compression, predictor):
    ok, enc = cv2.imencode(".tif", img, [
        cv2.IMWRITE_TIFF_COMPRESSION, compression,
        cv2.IMWRITE_TIFF_PREDICTOR, predictor])
    assert ok
    path.write_bytes(enc.tobytes())


@pytest.mark.parametrize("predictor", (1, 2))
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_cv2_written_tiff_equals_cv2(tmp_path, compression, predictor):
    rng = np.random.default_rng(compression + predictor)
    k = 0
    for shape in ((1, 1), (13, 17), (40, 1030), (9, 300)):
        for channels in (0, 3, 4):
            for dtype in (np.uint8, np.uint16):
                k += 1
                full = shape + ((channels,) if channels else ())
                img = rng.integers(0, np.iinfo(dtype).max + 1, full, dtype)
                if k % 2:  # smooth, as predictor 2 is meant for
                    img = np.cumsum(img // 64, axis=1).astype(dtype)
                p = tmp_path / f"c{k}.tif"
                _cv2_written(p, img, compression, predictor)
                assert_decodes_as_cv2(p)


def _samples(kind, h, w, rng):
    photometric, bps, spp, _ = KINDS[kind]
    return rng.integers(0, 1 << bps, (h, w, spp))


@settings(max_examples=250, deadline=None)
@given(st.sampled_from(sorted(KINDS)), st.integers(1, 40),
       st.integers(1, 40), st.sampled_from(COMPRESSIONS),
       st.sampled_from((1, 2)), st.booleans(),
       st.sampled_from((None, (16, 16), (32, 16), (16, 48))),
       st.integers(1, 7), st.booleans(), st.integers(0, 2 ** 32 - 1))
def test_built_tiff_equals_cv2(tmp_path_factory, kind, h, w, compression,
                               predictor, big, tile, rows, wide_map, seed):
    photometric, bps, spp, extra = KINDS[kind]
    rng = np.random.default_rng(seed)
    if bps < 8:
        predictor = 1
    cmap = None
    if photometric == 3:
        cmap = rng.integers(0, 65536 if wide_map else 256, (3, 1 << bps))
    data = wo_tiff_bytes(_samples(kind, h, w, rng), bps=bps,
                         photometric=photometric, compression=compression,
                         predictor=predictor, big_endian=big, tile=tile,
                         rows_per_strip=rows, colormap=cmap,
                         extra_samples=extra)
    p = tmp_path_factory.mktemp("tiff") / "t.tif"
    p.write_bytes(data)
    assert_decodes_as_cv2(p)


@pytest.mark.parametrize("kind", ("grey16", "grey_alpha8", "grey_alpha16",
                                  "white16"))
def test_grey_tiles_cut_by_the_right_edge_equal_cv2(tmp_path, kind):
    """libtiff's put16bitbwtile and its grey readers with two samples step
    a cut tile's rows by the hidden pixels' count in bytes."""
    rng = np.random.default_rng(7)
    photometric, bps, spp, extra = KINDS[kind]
    data = wo_tiff_bytes(_samples(kind, 37, 41, rng), bps=bps,
                         photometric=photometric, tile=(32, 16),
                         extra_samples=extra)
    p = tmp_path / "t.tif"
    p.write_bytes(data)
    assert_decodes_as_cv2(p)


@pytest.mark.parametrize("kind", ("grey8", "rgb8", "grey16", "palette8"))
def test_old_style_lzw_equals_cv2(tmp_path, kind):
    rng = np.random.default_rng(3)
    photometric, bps, spp, extra = KINDS[kind]
    cmap = rng.integers(0, 65536, (3, 256)) if photometric == 3 else None
    s = np.cumsum(_samples(kind, 60, 70, rng) % 3, axis=1) % (1 << bps)
    data = wo_tiff_bytes(s, bps=bps, photometric=photometric,
                         compression=5, colormap=cmap, lzw_compat=True)
    assert data[8:10] != b"\x80\x00"
    p = tmp_path / "t.tif"
    p.write_bytes(data)
    assert_decodes_as_cv2(p)


def test_the_first_page_of_a_two_page_tiff_equals_cv2(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, (19, 23), np.uint8)
    b = rng.integers(0, 256, (31, 17), np.uint8)
    p = tmp_path / "two.tif"
    Image.fromarray(a).save(p, save_all=True,
                            append_images=[Image.fromarray(b)],
                            compression="tiff_lzw")
    assert_decodes_as_cv2(p)
    with no_cv2():
        np.testing.assert_array_equal(dec.imread(p), a)


# --------------------------------------------------------------------------
# refused variants
# --------------------------------------------------------------------------

def _grey(**kw):
    return wo_tiff_bytes(np.zeros((8, 8), np.int64), **kw)


REFUSED = {
    "BigTIFF": lambda: b"II+\x00\x08\x00\x00\x00" + bytes(16),
    "TIFF JPEG compression": lambda: _grey(tags={259: (3, [7])}),
    "TIFF old-style JPEG compression": lambda: _grey(tags={259: (3, [6])}),
    "TIFF CCITT Group 3 compression": lambda: _grey(tags={259: (3, [3])}),
    "TIFF LZMA compression": lambda: _grey(tags={259: (3, [34925])}),
    "TIFF ZSTD compression": lambda: _grey(tags={259: (3, [50000])}),
    "TIFF WebP compression": lambda: _grey(tags={259: (3, [50001])}),
    "TIFF floating-point predictor": lambda: _grey(
        compression=5, tags={317: (3, [3])}),
    "TIFF floating-point samples": lambda: _grey(tags={339: (3, [3])}),
    "TIFF signed samples": lambda: _grey(tags={339: (3, [2])}),
    "TIFF separate planes (PlanarConfiguration 2)": lambda: _grey(
        tags={284: (3, [2])}),
    "TIFF orientation 3": lambda: _grey(tags={274: (3, [3])}),
    "TIFF FillOrder 2": lambda: _grey(tags={266: (3, [2])}),
    "TIFF photometric YCbCr": lambda: _grey(tags={262: (3, [6])}),
    "TIFF photometric separated (CMYK)": lambda: _grey(
        tags={262: (3, [5])}),
    "TIFF 4-bit grey": lambda: _grey(bps=4),
    "TIFF 2-bit palette": lambda: wo_tiff_bytes(
        np.zeros((8, 8), np.int64), bps=2, photometric=3,
        colormap=np.zeros((3, 4), np.int64)),
    "TIFF 8-bit RGB with 5 samples": lambda: wo_tiff_bytes(
        np.zeros((8, 8, 5), np.int64), photometric=2),
    "TIFF predictor 2 at 1 bits": lambda: _grey(
        bps=1, compression=5, tags={317: (3, [2])}),
}


@pytest.mark.parametrize("variant", sorted(REFUSED))
def test_refused_variant_is_named_and_routes_to_opencv(tmp_path,
                                                       monkeypatch, variant):
    """Named from the header alone; ``imread`` raises; without cv2 the
    image source raises naming it; with cv2 the file goes to
    ``cv2.imread`` (a stand-in here, as cv2 decodes some of these and
    fails on others)."""
    p = tmp_path / "f_000.tif"
    p.write_bytes(REFUSED[variant]())
    assert dec.refused_variant(p) == variant
    with no_cv2(), pytest.raises(ValueError, match="not decoded"):
        dec.imread(p)
    assert_routes_to_opencv(p, variant, monkeypatch)


def test_a_corrupt_tiff_raises_and_never_falls_back(tmp_path, monkeypatch):
    data = bytearray(wo_tiff_bytes(np.arange(400).reshape(20, 20) % 7,
                                   compression=5))
    data[9:40] = bytes(31)  # the LZW codes of the first strip
    p = tmp_path / "f_000.tif"
    p.write_bytes(bytes(data))
    assert dec.refused_variant(p) is None
    monkeypatch.setattr(port_video, "_cv2_mod", SimpleNamespace(
        imread=lambda *a: pytest.fail("fell back to OpenCV")))
    with pytest.raises(IOError):
        port_video.VideoSource([str(p)]).get(0)
