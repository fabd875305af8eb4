"""The port's JPEG decoder (trex_tpu_torch/io/image_decode.py with
native/jpeg.cpp) against ``cv2.imread`` of OpenCV 5.0.0 (libjpeg-turbo
3.1) under ``IMREAD_GRAYSCALE`` and ``IMREAD_COLOR``, bit for bit, the
port's call made with cv2 blocked: every variant ``cv2.imwrite`` writes
(quality 1, 50, 90 and 100; the five sampling factors; progressive;
optimised tables; restart intervals 0, 1 and 7; grey; sizes that leave
partial MCUs), the same under hypothesis over every quality, and files
built here for what cv2 does not write: SOF1 with 16-bit quantisation
tables, EXIF orientations 1-8 in both byte orders, RGB colour spaces
(Adobe transform 0, component ids R G B), coefficients whose IDCT
overflows 16 bits. Each refused variant is named from its header, raises
without OpenCV and decodes through it where it is installed. Tolerance 0.
"""
import re
import struct
import sys
from contextlib import contextmanager
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import trex_tpu_torch.io.video as port_video
from trex_tpu_torch.io import image_decode as dec

FLAGS = ((False, cv2.IMREAD_GRAYSCALE), (True, cv2.IMREAD_COLOR))
SAMPLING = {
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444}
SIZES = ((1, 1), (7, 9), (17, 33), (240, 333))


@contextmanager
def no_cv2():
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        sys.modules["cv2"] = saved


def assert_decodes_as_cv2(path):
    for colour, flag in FLAGS:
        want = cv2.imread(str(path), flag)
        assert want is not None, path
        with no_cv2():
            got = dec.imread(path, colour)
        assert got.dtype == np.uint8 and got.shape == want.shape, (
            colour, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"colour={colour}")


def _image(h, w, seed, colour=True, smooth=True):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3) if colour else (h, w), np.uint8)
    if smooth and min(h, w) > 4:
        img = cv2.GaussianBlur(img, (5, 5), 1.5)
    return img


def _write(path, img, quality=90, sampling="420", progressive=0,
           optimize=0, restart=0):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
              cv2.IMWRITE_JPEG_OPTIMIZE, optimize,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    path.write_bytes(enc.tobytes())
    return enc.tobytes()


@pytest.mark.parametrize("progressive", (0, 1))
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_cv2_written_colour_jpeg_equals_cv2(tmp_path, sampling,
                                            progressive):
    """Every quality, restart interval and table optimisation at sizes
    that leave partial MCUs, under one sampling factor and scan mode."""
    k = 0
    for h, w in SIZES:
        for quality in (1, 50, 90, 100):
            for restart in (0, 1, 7):
                for optimize in (0, 1):
                    k += 1
                    p = tmp_path / f"f{k}.jpg"
                    _write(p, _image(h, w, k, smooth=quality > 50), quality,
                           sampling, progressive, optimize, restart)
                    assert_decodes_as_cv2(p)


@pytest.mark.parametrize("progressive", (0, 1))
def test_cv2_written_grey_jpeg_equals_cv2(tmp_path, progressive):
    k = 0
    for h, w in SIZES:
        for quality in (1, 50, 90, 100):
            for restart in (0, 1, 7):
                k += 1
                p = tmp_path / f"g{k}.jpg"
                _write(p, _image(h, w, k, colour=False), quality,
                       progressive=progressive, restart=restart)
                assert_decodes_as_cv2(p)


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 100), st.integers(1, 48), st.integers(1, 48),
       st.sampled_from(sorted(SAMPLING)), st.booleans(), st.booleans(),
       st.integers(0, 9), st.booleans(), st.booleans(),
       st.integers(0, 2 ** 32 - 1))
def test_jpeg_under_hypothesis_equals_cv2(tmp_path_factory, quality, h, w,
                                          sampling, progressive, optimize,
                                          restart, colour, smooth, seed):
    p = tmp_path_factory.mktemp("hyp") / "h.jpg"
    _write(p, _image(h, w, seed, colour, smooth), quality, sampling,
           int(progressive), int(optimize), restart)
    assert_decodes_as_cv2(p)


@pytest.mark.parametrize("top", (256, 1000, 40000, 65535))
def test_extended_sequential_with_16_bit_tables_equals_cv2(tmp_path, top):
    """SOF1 with a 16-bit quantisation table (entries above 32767 are
    negative in libjpeg's 16-bit multipliers)."""
    rng = np.random.default_rng(top)
    quant = rng.integers(1, top + 1, 64)
    coefs = rng.integers(-3, 4, (12, 64)) * (rng.random((12, 64)) < 0.3)
    p = tmp_path / "x.jpg"
    data = chip_smoke.wo_jpeg_bytes(coefs=coefs, quant=quant, size=(19, 29),
                                    extended=True)
    assert data[data.index(b"\xff\xc1"):][:2] == b"\xff\xc1"
    p.write_bytes(data)
    assert_decodes_as_cv2(p)


@pytest.mark.parametrize("kind", ("wrap", "dequant16", "sums16", "dc16"))
def test_coefficients_past_16_bits_equal_cv2(tmp_path, kind):
    """libjpeg-turbo's vector IDCT on coefficients no encoder writes:
    samples far outside 0..255, products and sums past 16 bits."""
    rng = np.random.default_rng(len(kind))
    coefs = np.zeros((24, 64), np.int64)
    if kind == "wrap":
        coefs[:, 1:10] = rng.integers(-600, 600, (24, 9))
        quant = np.full(64, 64)
    elif kind == "dequant16":
        coefs[:, :20] = rng.integers(-1000, 1000, (24, 20))
        quant = np.full(64, 255)
    elif kind == "sums16":
        coefs[:, [0, 1, 3, 5, 7, 8, 24, 40, 56]] = rng.choice(
            [-1023, 1023], (24, 9))
        quant = np.full(64, 31)
    else:
        coefs[:, 0] = rng.integers(-1023, 1024, 24)
        quant = np.full(64, 255)
    p = tmp_path / f"{kind}.jpg"
    p.write_bytes(chip_smoke.wo_jpeg_bytes(coefs=coefs, quant=quant,
                                           size=(24, 64)))
    assert_decodes_as_cv2(p)


def _exif(orientation, big):
    e = ">" if big else "<"
    tiff = ((b"MM\x00*" if big else b"II*\x00") + struct.pack(e + "I", 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIH", 0x112, 3, 1, orientation) + b"\0\0"
            + struct.pack(e + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("big", (False, True))
@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_equals_cv2(tmp_path, orientation, big):
    """Orientations 2-8 flip and transpose under both flags, others leave
    the image; 4:2:0 at an odd size."""
    data = _write(tmp_path / "a.jpg", _image(13, 22, orientation), 90)
    p = tmp_path / "o.jpg"
    p.write_bytes(data[:2] + _exif(orientation, big) + data[2:])
    assert_decodes_as_cv2(p)


def _segments(data):
    """(marker, start, end) of each marker segment before the first
    scan."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        out.append((data[pos + 1], pos, pos + 2 + n))
        pos += 2 + n
    return out


def _without_jfif(data):
    for m, a, b in _segments(data):
        if m == 0xE0:
            return data[:a] + data[b:]
    return data


@pytest.mark.parametrize("space", ("adobe_rgb", "adobe_ycc", "ids_rgb",
                                   "ids_other"))
def test_colour_space_markers_equal_cv2(tmp_path, space):
    """Three components read as RGB under an Adobe marker with transform
    0 or, without JFIF and Adobe markers, with the ids R G B (grey through
    jdcolor.c's rgb_gray_convert); as YCbCr otherwise."""
    data = _without_jfif(_write(tmp_path / "a.jpg", _image(21, 30, 3), 92,
                                "444"))
    if space.startswith("adobe"):
        body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0,
                                 0 if space == "adobe_rgb" else 1])
        data = data[:2] + b"\xff\xee" + struct.pack(">H", len(body) + 2) \
            + body + data[2:]
    else:
        ids = b"RGB" if space == "ids_rgb" else b"\x04\x05\x06"
        out = bytearray(data)
        sof = next(a for m, a, b in _segments(data) if m == 0xC0)
        for i in range(3):
            out[sof + 10 + 3 * i] = ids[i]
        sos = data.index(b"\xff\xda")
        for i in range(3):
            out[sos + 5 + 2 * i] = ids[i]
        data = bytes(out)
    p = tmp_path / "s.jpg"
    p.write_bytes(data)
    assert_decodes_as_cv2(p)


# --------------------------------------------------------------------------
# refused variants
# --------------------------------------------------------------------------

def _sof_patched(data, marker=None, precision=None):
    out = bytearray(data)
    at = data.index(b"\xff\xc0")
    if marker is not None:
        out[at + 1] = marker
    if precision is not None:
        out[at + 4] = precision
    return bytes(out)


def _header_only(nf, h=16, w=16, factors=None):
    """SOI, a baseline frame header of `nf` components, EOI."""
    factors = factors or [0x11] * nf
    comps = b"".join(bytes([i + 1, f, 0]) for i, f in enumerate(factors))
    body = struct.pack(">BHHB", 8, h, w, nf) + comps
    return (b"\xff\xd8\xff\xc0" + struct.pack(">H", len(body) + 2) + body
            + b"\xff\xd9")


def _first_scans(data, keep):
    """A progressive file cut after its first `keep` scans."""
    pos = -1
    for _ in range(keep + 1):
        pos = data.index(b"\xff\xda", pos + 1)
    return data[:pos] + b"\xff\xd9"


REFUSED = ("JPEG arithmetic coding", "JPEG lossless", "JPEG hierarchical",
           "JPEG 12-bit precision", "JPEG 16-bit precision",
           "JPEG four components (CMYK, YCCK)", "JPEG 2 components",
           "JPEG height from a DNL marker",
           "JPEG sampling factors that do not divide the largest",
           "JPEG progressive scans that leave coefficients incomplete")


def _refused(base):
    """Each refused variant but the progressive one, from a baseline
    file."""
    return {
        "JPEG arithmetic coding": _sof_patched(base, 0xC9),
        "JPEG lossless": _sof_patched(base, 0xC3),
        "JPEG hierarchical": _sof_patched(base, 0xC5),
        "JPEG 12-bit precision": _sof_patched(base, precision=12),
        "JPEG 16-bit precision": _sof_patched(base, precision=16),
        "JPEG four components (CMYK, YCCK)": _header_only(4),
        "JPEG 2 components": _header_only(2),
        "JPEG height from a DNL marker": _header_only(1, h=0),
        "JPEG sampling factors that do not divide the largest":
            _header_only(3, factors=[0x31, 0x21, 0x11]),
    }


def _progressive_cut(tmp_path):
    data = _write(tmp_path / "p.jpg", _image(32, 40, 1), 90, progressive=1)
    return _first_scans(data, 3)


def test_refused_variants_are_named_from_the_header(tmp_path):
    base = _write(tmp_path / "b.jpg", _image(16, 24, 0), 90)
    cases = dict(_refused(base))
    cases[REFUSED[-1]] = _progressive_cut(tmp_path)
    assert sorted(cases) == sorted(REFUSED)
    for i, (variant, data) in enumerate(cases.items()):
        p = tmp_path / f"r{i}.jpg"
        p.write_bytes(data)
        assert dec.refused_variant(p) == variant
        with no_cv2(), pytest.raises(ValueError, match="not decoded"):
            dec.imread(p)
    assert dec.refused_variant(tmp_path / "b.jpg") is None


@pytest.mark.parametrize("variant", REFUSED)
def test_refused_variant_routes_to_opencv(tmp_path, monkeypatch, variant):
    """Without cv2 the image source raises naming the variant; with it
    the file goes to ``cv2.imread`` (a stand-in here, as cv2 itself
    decodes these variants or fails on them)."""
    if variant == REFUSED[-1]:
        data = _progressive_cut(tmp_path)
    else:
        data = _refused(_write(tmp_path / "b.jpg", _image(16, 24, 0),
                               90))[variant]
    p = tmp_path / "f_000.jpg"
    p.write_bytes(data)
    assert_routes_to_opencv(p, variant, monkeypatch)


def assert_routes_to_opencv(path, variant, monkeypatch):
    """An image source over `path` raises naming `variant` with cv2
    blocked, and hands the file to ``cv2.imread`` (a stand-in) where cv2
    is there."""
    src = port_video.VideoSource([str(path)])
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(port_video, "_cv2_mod", None)
    with pytest.raises(RuntimeError, match=re.escape(
            f"OpenCV is required for image decode ({variant})")):
        src.get(0)
    calls = []
    frame = np.full((3, 4), 7, np.uint8)
    monkeypatch.setattr(port_video, "_cv2_mod", SimpleNamespace(
        IMREAD_COLOR=1, IMREAD_GRAYSCALE=0,
        imread=lambda p, flag: calls.append((p, flag)) or frame))
    assert src.get(0) is frame and calls == [(str(path), 0)]


def test_a_corrupt_jpeg_raises_and_never_falls_back(tmp_path, monkeypatch):
    """An error inside a variant the port decodes propagates: a truncated
    scan raises IOError, and the source does not call OpenCV."""
    data = _write(tmp_path / "b.jpg", _image(64, 64, 0), 90)
    p = tmp_path / "f_000.jpg"
    p.write_bytes(data[:len(data) // 2])
    assert dec.refused_variant(p) is None
    monkeypatch.setattr(port_video, "_cv2_mod", SimpleNamespace(
        imread=lambda *a: pytest.fail("fell back to OpenCV")))
    with pytest.raises(IOError):
        port_video.VideoSource([str(p)]).get(0)


def test_fixtures_are_small_and_decode_as_cv2():
    files = sorted(chip_smoke.WO_JPEG_FIXTURES.glob("*.jpg"))
    assert len(files) == 6
    assert all(f.stat().st_size < 16 * 1024 for f in files)
    for f in files:
        assert_decodes_as_cv2(f)
