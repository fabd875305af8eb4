"""The port's PNG and BMP decoder (trex_tpu_torch/io/image_decode.py)
against ``cv2.imread`` under ``IMREAD_GRAYSCALE`` and ``IMREAD_COLOR``,
bit for bit under hypothesis: files written by ``cv2.imwrite`` and files
built here byte by byte (``zlib`` plus chunks for PNG palettes, Adam7,
low bit depths, grey with alpha and every row filter; headers, palettes
and rows for BMP), which ``cv2.imwrite`` cannot write. Tolerance 0."""
import struct
import zlib

import cv2
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from trex_tpu_torch.io import image_decode as dec

FLAGS = ((False, cv2.IMREAD_GRAYSCALE), (True, cv2.IMREAD_COLOR))
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}


def _both(path):
    for colour, flag in FLAGS:
        want = cv2.imread(str(path), flag)
        assert want is not None
        got = dec.imread(path, colour)
        assert got.dtype == np.uint8 and got.shape == want.shape, (
            colour, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"colour={colour}")


# --------------------------------------------------------------------------
# PNG files built here
# --------------------------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _pack_rows(samples, depth):
    """(rows, n) integer samples -> packed scan-line bytes a row."""
    rows, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(rows, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = ((samples[..., None] >> np.arange(depth - 1, -1, -1)) & 1)
    bits = bits.reshape(rows, n * depth).astype(np.uint8)
    return np.packbits(bits, axis=1)


def _filter(lines, bpp, kinds, rng):
    """Apply PNG row filters of the given kinds (cycled) to packed rows."""
    out = []
    prev = np.zeros(lines.shape[1], np.int64)
    for y, line in enumerate(lines.astype(np.int64)):
        f = kinds[y % len(kinds)] if kinds else int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]]) \
            if len(line) > bpp else np.zeros(len(line), np.int64)
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]]) \
            if len(line) > bpp else np.zeros(len(line), np.int64)
        if f == 0:
            enc = line
        elif f == 1:
            enc = line - left
        elif f == 2:
            enc = line - prev
        elif f == 3:
            enc = line - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            enc = line - pred
        out.append(np.concatenate([[f], enc & 255]).astype(np.uint8))
        prev = line
    return b"".join(o.tobytes() for o in out)


def write_png(path, samples, ctype, depth, interlace=False, palette=None,
              seed=0, extra=()):
    """A PNG of (h, w, channels) samples at the given colour type and bit
    depth, each row under a random filter."""
    rng = np.random.default_rng(seed)
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            part = samples[y0::dy, x0::dx]
            if part.size:
                ph, pw = part.shape[:2]
                raw += _filter(_pack_rows(part.reshape(ph, pw * c), depth),
                               bpp, (), rng)
    else:
        raw = _filter(_pack_rows(samples.reshape(h, w * c), depth), bpp, (),
                      rng)
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, 1 if interlace else 0)))
    for kind, body in extra:
        data += _chunk(kind, body)
    if palette is not None:
        data += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")
    path.write_bytes(data)


PNG_KINDS = [(t, d) for t, ds in DEPTHS.items() for d in ds]


@settings(max_examples=120, deadline=None)
@given(st.sampled_from(PNG_KINDS), st.integers(1, 40), st.integers(1, 40),
       st.booleans(), st.integers(0, 2 ** 32 - 1))
def test_built_png_equals_cv2(tmp_path_factory, kind, h, w, interlace, seed):
    ctype, depth = kind
    rng = np.random.default_rng(seed)
    c = CHANNELS[ctype]
    palette = None
    if ctype == 3:
        n = int(rng.integers(1, 2 ** depth + 1))
        palette = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, n, (h, w, 1))
    else:
        samples = rng.integers(0, 2 ** depth, (h, w, c))
        if c >= 3 and rng.random() < 0.3:
            samples[..., 1] = samples[..., 2] = samples[..., 0]
    path = tmp_path_factory.mktemp("png") / "f.png"
    write_png(path, samples, ctype, depth, interlace, palette, seed)
    _both(path)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 50), st.integers(1, 50),
       st.sampled_from([1, 3, 4]), st.booleans(),
       st.integers(0, 2 ** 32 - 1))
def test_cv2_written_png_equals_cv2(tmp_path_factory, h, w, c, wide, seed):
    rng = np.random.default_rng(seed)
    dtype = np.uint16 if wide else np.uint8
    shape = (h, w) if c == 1 else (h, w, c)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = tmp_path_factory.mktemp("png") / "f.png"
    assert cv2.imwrite(str(path), img)
    _both(path)


def test_grey_of_colour_is_libpngs_not_cvtcolor(tmp_path):
    """libpng's truncated grey of an 8-bit colour PNG differs from
    cvtColor on some pixels of a random image; the decoder gives
    libpng's."""
    img = np.random.default_rng(0).integers(0, 256, (64, 80, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "c.png"), img)
    got = dec.imread(tmp_path / "c.png")
    want = cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(got, want)
    assert (cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) != want).any()


def test_png_refusals(tmp_path):
    rng = np.random.default_rng(1)
    samples = rng.integers(0, 256, (6, 7, 3))
    write_png(tmp_path / "g.png", samples, 2, 8,
              extra=((b"gAMA", struct.pack(">I", 45455)),))
    with pytest.raises(ValueError, match="gamma"):
        dec.imread(tmp_path / "g.png")
    # colour reads need no gamma conversion
    np.testing.assert_array_equal(
        dec.imread(tmp_path / "g.png", True),
        cv2.imread(str(tmp_path / "g.png"), cv2.IMREAD_COLOR))
    bad = bytearray((tmp_path / "g.png").read_bytes())
    bad[-20] ^= 0xFF  # inside the IDAT chunk
    (tmp_path / "bad.png").write_bytes(bytes(bad))
    with pytest.raises(IOError):
        dec.imread(tmp_path / "bad.png")
    (tmp_path / "x.png").write_bytes(b"GIF89a")
    with pytest.raises(IOError):
        dec.imread(tmp_path / "x.png")


# --------------------------------------------------------------------------
# BMP
# --------------------------------------------------------------------------

def write_bmp(path, h, w, bpp, rng, top_down=False, used=0, core=False):
    """A BI_RGB BMP of random pixels at `bpp` bits (a random palette
    below 16 bits)."""
    stride = ((w * bpp + 31) // 32) * 4
    if bpp <= 8:
        n = used or 1 << bpp
        entry = 3 if core else 4
        pal = rng.integers(0, 256, (n, entry)).astype(np.uint8)
        if not core:
            pal[:, 3] = 0
        idx = rng.integers(0, n, (h, w))
        bits = ((idx[..., None] >> np.arange(bpp - 1, -1, -1)) & 1)
        rows = np.packbits(bits.reshape(h, w * bpp).astype(np.uint8),
                           axis=1)
        palette = pal.tobytes()
    else:
        rows = rng.integers(0, 256, (h, w * bpp // 8)).astype(np.uint8)
        palette = b""
        n = 0
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    if core:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1,
                           bpp, 0, stride * h, 2835, 2835, used, 0)
    offset = 14 + len(info) + len(palette)
    head = struct.pack("<2sIHHI", b"BM", offset + stride * h, 0, 0, offset)
    path.write_bytes(head + info + palette + body.tobytes())


@settings(max_examples=120, deadline=None)
@given(st.sampled_from([1, 4, 8, 24, 32]), st.integers(1, 40),
       st.integers(1, 40), st.booleans(), st.booleans(),
       st.integers(0, 2 ** 32 - 1))
def test_built_bmp_equals_cv2(tmp_path_factory, bpp, h, w, top_down,
                              partial, seed):
    rng = np.random.default_rng(seed)
    used = int(rng.integers(1, 2 ** bpp + 1)) if bpp <= 8 and partial else 0
    path = tmp_path_factory.mktemp("bmp") / "f.bmp"
    write_bmp(path, h, w, bpp, rng, top_down, used)
    _both(path)


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 50), st.integers(1, 50), st.sampled_from([1, 3]),
       st.integers(0, 2 ** 32 - 1))
def test_cv2_written_bmp_equals_cv2(tmp_path_factory, h, w, c, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w) if c == 1 else (h, w, c), np.uint8)
    path = tmp_path_factory.mktemp("bmp") / "f.bmp"
    assert cv2.imwrite(str(path), img)
    _both(path)


def test_core_header_bmp_equals_cv2(tmp_path):
    write_bmp(tmp_path / "c.bmp", 9, 13, 8, np.random.default_rng(2),
              core=True)
    _both(tmp_path / "c.bmp")


def test_bmp_refusals(tmp_path):
    rng = np.random.default_rng(3)
    write_bmp(tmp_path / "a.bmp", 4, 4, 8, rng)
    data = bytearray((tmp_path / "a.bmp").read_bytes())
    for code, word in ((1, "run-length"), (3, "bitfield")):
        data[30:34] = struct.pack("<I", code)
        (tmp_path / "r.bmp").write_bytes(bytes(data))
        with pytest.raises(ValueError, match=word):
            dec.imread(tmp_path / "r.bmp")
    data[30:34] = struct.pack("<I", 0)
    data[28:30] = struct.pack("<H", 16)
    (tmp_path / "s.bmp").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="16-bit"):
        dec.imread(tmp_path / "s.bmp")
