"""PNG and BMP decoding without OpenCV (the machine with the card has
none): :func:`imread` gives the pixels ``cv2.imread(path, IMREAD_COLOR)``
or ``cv2.imread(path, IMREAD_GRAYSCALE)`` of OpenCV 5.0.0 gives
(``tests/test_torch_image_decode.py`` holds it to cv2):

- PNG (through libpng in OpenCV): colour types 0, 2, 3, 4 and 6 at every
  legal bit depth, Adam7 interlace; the stream inflated by ``zlib``, the
  row filters undone in ``native/imgproc.cpp``; alpha stripped, a palette
  expanded, grey below 8 bits scaled to 0..255, 16 bits cut to their high
  byte. libpng's own colour-to-grey conversion serves ``IMREAD_GRAYSCALE``:
  ``(9797 r + 19234 g + 3737 b) >> 15`` on 8 bits, and ``(... + 2^14) >>
  15`` on 16 bits before the cut. A colour file with gamma or colour-space
  chunks (``gAMA``, ``sRGB``, ``iCCP``, ``cHRM``), which libpng converts
  through its gamma tables, and an ``eXIf`` orientation under
  ``IMREAD_COLOR`` raise.
- BMP (OpenCV's own decoder): 1-, 4- and 8-bit palettes, 24 and 32 bits,
  bottom-up and top-down rows; ``IMREAD_GRAYSCALE`` through OpenCV's
  ``(1868 b + 9617 g + 4899 r + 2^13) >> 14``. Run-length and bitfield
  files raise, naming the format.

Neither grey conversion is ``cvtColor(COLOR_BGR2GRAY)``.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

EXTENSIONS = (".png", ".bmp")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libpng's png_set_rgb_to_gray(png, 1, 0.299, 0.587): the coefficients in
# 1/32768, truncated, blue the rest
_PNG_RC, _PNG_GC = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_PNG_BC = 32768 - _PNG_RC - _PNG_GC
# OpenCV's icvCvt_BGR2Gray_8u_C3C1R: 14-bit rounded luma weights
_BMP_CR = int(0.299 * (1 << 14) + 0.5)
_BMP_CG = int(0.587 * (1 << 14) + 0.5)
_BMP_CB = (1 << 14) - _BMP_CR - _BMP_CG
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (x start, y start, x step, y step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def can_decode(path) -> bool:
    """Whether :func:`imread` decodes files of this name (PNG, BMP)."""
    return Path(str(path)).suffix.lower() in EXTENSIONS


def imread(path, color: bool = False) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR if color else IMREAD_GRAYSCALE)``
    of a PNG or BMP file: (h, w, 3) BGR or (h, w) grey uint8. Raises
    IOError for a file that is not a valid PNG or BMP and ValueError for
    a variant the port does not decode."""
    data = Path(path).read_bytes()
    if data.startswith(_PNG_SIGNATURE):
        return _decode_png(data, color, str(path))
    if data[:2] == b"BM":
        return _decode_bmp(data, color, str(path))
    raise IOError(f"{path}: neither a PNG nor a BMP file")


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

def _png_chunks(data: bytes, name: str):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or pos + 12 + n > len(data):
            raise IOError(f"{name}: truncated PNG chunk {kind!r}")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if kind[0] & 0x20 == 0 and zlib.crc32(kind + body) & 0xFFFFFFFF \
                != crc:
            raise IOError(f"{name}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise IOError(f"{name}: PNG without IEND")


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int,
              name: str) -> np.ndarray:
    from ..ops.labeling import _lib

    lines = np.ascontiguousarray(raw[:rows * stride]).copy()
    if lines.size < rows * stride:
        raise IOError(f"{name}: PNG image data too short")
    if rows and _lib().trex_png_unfilter(
            lines.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rows,
            stride, bpp) != 0:
        raise IOError(f"{name}: unknown PNG row filter")
    return lines.reshape(rows, stride)[:, 1:]


def _samples(lines: np.ndarray, w: int, channels: int,
             depth: int) -> np.ndarray:
    """(rows, w, channels) samples of unfiltered scan lines."""
    rows = lines.shape[0]
    n = w * channels
    if depth == 16:
        v = lines[:, :2 * n].reshape(rows, n, 2).astype(np.uint16)
        out = (v[..., 0] << 8) | v[..., 1]
    elif depth == 8:
        out = lines[:, :n]
    else:
        bits = np.unpackbits(lines, axis=1)[:, :n * depth]
        bits = bits.reshape(rows, n, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (bits * weights).sum(axis=2).astype(np.uint8)
    return out.reshape(rows, w, channels)


def _decode_png(data: bytes, color: bool, name: str) -> np.ndarray:
    header = None
    palette = None
    idat = []
    ancillary = set()
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        else:
            ancillary.add(kind)
    if header is None or not idat:
        raise IOError(f"{name}: PNG without IHDR or IDAT")
    w, h, depth, ctype, comp, filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] \
            or comp != 0 or filt != 0 or interlace not in (0, 1) \
            or w == 0 or h == 0:
        raise IOError(f"{name}: invalid PNG header {header}")
    if ctype == 3 and palette is None:
        raise IOError(f"{name}: palette PNG without PLTE")
    colour = ctype in (2, 3, 6)
    if not color and colour and ancillary & {b"gAMA", b"sRGB", b"iCCP",
                                             b"cHRM"}:
        raise ValueError(
            f"{name}: a colour PNG with gamma or colour-space chunks read "
            "as grey (libpng's gamma-corrected grey conversion) is not "
            "decoded without OpenCV")
    if color and b"eXIf" in ancillary:
        raise ValueError(f"{name}: a PNG with an eXIf chunk (its "
                         "orientation) is not decoded without OpenCV")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise IOError(f"{name}: corrupt PNG image data ({e})") from e
    channels = _CHANNELS[ctype]
    bits = channels * depth
    bpp = max(1, bits // 8)
    if interlace == 0:
        stride = 1 + (w * bits + 7) // 8
        img = _samples(_unfilter(raw, h, stride, bpp, name), w, channels,
                       depth)
    else:
        img = np.zeros((h, w, channels),
                       np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw = (w - x0 + dx - 1) // dx if w > x0 else 0
            ph = (h - y0 + dy - 1) // dy if h > y0 else 0
            if pw == 0 or ph == 0:
                continue
            stride = 1 + (pw * bits + 7) // 8
            part = _unfilter(raw[pos:], ph, stride, bpp, name)
            pos += ph * stride
            img[y0::dy, x0::dx] = _samples(part, pw, channels, depth)
    return _png_output(img, ctype, depth, palette, color)


def _png_output(img, ctype, depth, palette, color) -> np.ndarray:
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette[:256]
        rgb = pal[img[..., 0]]
        depth = 8
    elif ctype in (2, 6):
        rgb = img[..., :3]
    else:
        grey = img[..., 0]
        if depth < 8:
            grey = (grey.astype(np.uint16) * (255 // ((1 << depth) - 1))
                    ).astype(np.uint8)
        elif depth == 16:
            grey = (grey >> 8).astype(np.uint8)
        if color:
            return np.repeat(grey[..., None], 3, axis=2)
        return np.ascontiguousarray(grey)
    if color:
        bgr = rgb[..., ::-1]
        if depth == 16:
            bgr = bgr >> 8
        return np.ascontiguousarray(bgr.astype(np.uint8))
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if depth == 16:
        grey16 = (_PNG_RC * r + _PNG_GC * g + _PNG_BC * b + (1 << 14)) >> 15
        return (grey16 >> 8).astype(np.uint8)
    return ((_PNG_RC * r + _PNG_GC * g + _PNG_BC * b) >> 15).astype(np.uint8)


# --------------------------------------------------------------------------
# BMP
# --------------------------------------------------------------------------

_BMP_COMPRESSION = {1: "run-length (RLE8)", 2: "run-length (RLE4)",
                    3: "bitfield (BI_BITFIELDS)", 4: "JPEG", 5: "PNG",
                    6: "alpha-bitfield (BI_ALPHABITFIELDS)"}


def _bmp_grey(bgr: np.ndarray) -> np.ndarray:
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * _BMP_CB + g * _BMP_CG + r * _BMP_CR + (1 << 13)) >> 14
            ).astype(np.uint8)


def _decode_bmp(data: bytes, color: bool, name: str) -> np.ndarray:
    if len(data) < 26:
        raise IOError(f"{name}: truncated BMP header")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size == 12:
        w, h, _planes, bpp = struct.unpack("<HHHH", data[18:26])
        compression, used, entry = 0, 0, 3
    elif size >= 40 and len(data) >= 14 + 40:
        w, h, _planes, bpp, compression = struct.unpack("<iiHHI",
                                                        data[18:34])
        (used,) = struct.unpack("<I", data[46:50])
        entry = 4
    else:
        raise IOError(f"{name}: unknown BMP header of {size} bytes")
    if compression != 0:
        kind = _BMP_COMPRESSION.get(compression, f"compression {compression}")
        raise ValueError(f"{name}: {kind} BMP files are not decoded without "
                         "OpenCV")
    if bpp not in (1, 4, 8, 24, 32):
        raise ValueError(f"{name}: {bpp}-bit BMP files are not decoded "
                         "without OpenCV")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise IOError(f"{name}: invalid BMP size {w}x{h}")
    stride = ((w * bpp + 31) // 32) * 4
    pixels = np.frombuffer(data, np.uint8, count=stride * h, offset=offset) \
        if offset + stride * h <= len(data) else None
    if pixels is None:
        raise IOError(f"{name}: BMP pixel data too short")
    rows = pixels.reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp <= 8:
        n = used if used else 1 << bpp
        if n > 256:
            raise IOError(f"{name}: BMP palette of {n} entries")
        start = 14 + size
        pal = np.zeros((256, 3), np.uint8)
        table = np.frombuffer(data, np.uint8, count=n * entry, offset=start)
        pal[:n] = table.reshape(n, entry)[:, :3]
        if bpp == 8:
            idx = rows[:, :w]
        else:
            bits = np.unpackbits(rows, axis=1)[:, :w * bpp]
            bits = bits.reshape(h, w, bpp)
            weights = (1 << np.arange(bpp - 1, -1, -1)).astype(np.uint8)
            idx = (bits * weights).sum(axis=2).astype(np.uint8)
        if color:
            return np.ascontiguousarray(pal[idx])
        return _bmp_grey(pal)[idx]
    cn = bpp // 8
    bgr = rows[:, :w * cn].reshape(h, w, cn)[..., :3]
    if color:
        return np.ascontiguousarray(bgr)
    return _bmp_grey(bgr)
