"""PNG, BMP, JPEG and TIFF decoding without OpenCV (the machine with the
card has none): :func:`imread` gives the pixels ``cv2.imread(path,
IMREAD_COLOR)`` or ``cv2.imread(path, IMREAD_GRAYSCALE)`` of OpenCV 5.0.0
gives (``tests/test_torch_image_decode.py``, ``test_torch_jpeg.py`` and
``test_torch_tiff.py`` hold it to cv2). The decoder is chosen by the
file's first bytes, as cv2 chooses it, not by its name.

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
- JPEG (libjpeg-turbo 3.1 in OpenCV, ``native/jpeg.cpp``): baseline and
  extended sequential (SOF0, SOF1, 16-bit quantisation tables) and
  progressive (SOF2) Huffman coding at 8 bits, one or three components,
  any sampling factors that divide the largest (every one cv2 writes:
  4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1), restart intervals. The ISLOW
  integer IDCT; fancy upsampling (triangle filters for h2v1 and h2v2 on
  components wider than 2 samples and for h1v2, replication otherwise);
  YCbCr to BGR through jdcolor.c's tables. Three components are YCbCr
  but under an Adobe marker with transform 0 or, without JFIF and Adobe
  markers, with the component ids ``R``, ``G``, ``B``. ``IMREAD_GRAYSCALE``
  of a YCbCr file is its Y plane alone (its chroma is never decoded), of
  an RGB file jdcolor.c's ``(19595 r + 38470 g + 7471 b + 2^15) >> 16``.
  The EXIF orientation of the first APP1 segment (2-8) is applied under
  both flags, as OpenCV's ``ApplyExifOrientation`` does.
- TIFF (libtiff 4.7 in OpenCV, which reads every 8-bit result through
  ``TIFFReadRGBA*``; ``native/tiffcodec.cpp``): classic TIFF in either
  byte order, the first IFD, strips or tiles, PlanarConfiguration 1,
  compression none, LZW (new and old style), Deflate and PackBits,
  predictor 1 and 2 (8 and 16 bits), orientation 1. MinIsBlack and
  MinIsWhite at 1, 8 and 16 bits (16 bits cut to the high byte,
  MinIsWhite inverted, a second sample dropped), RGB at 8 and 16 bits
  (16 bits through libtiff's ``(v + 128) / 257``; a fourth sample is
  associated alpha and dropped, unless ExtraSamples calls it unassociated,
  when libtiff premultiplies: ``(v a + 127) / 255``), Palette at 1, 4 and
  8 bits (a colour map with no entry above 255 taken as 8-bit, otherwise
  each entry's high byte). ``IMREAD_GRAYSCALE`` converts the RGB result
  through OpenCV's ``(1868 b + 9617 g + 4899 r + 2^13) >> 14``, grey
  files included (which leaves grey unchanged).

Neither grey conversion of PNG or BMP is ``cvtColor(COLOR_BGR2GRAY)``.

A JPEG or TIFF variant the port does not decode is recognised from its
headers (:func:`refused_variant`, which names it): JPEG arithmetic coding
(SOF9-11, 13-15), lossless (SOF3, 7, 11, 15), hierarchical (SOF5-7, 13-15,
DHP), 12- and 16-bit precision, four components (CMYK, YCCK), two
components, a height given by DNL, sampling factors that do not divide
the largest, progressive scans that leave a coefficient incomplete (which
libjpeg smooths); BigTIFF, TIFF compressions other than the four, the
floating-point predictor, predictor 2 below 8 bits, float or signed
samples, PlanarConfiguration 2, orientations other than 1, FillOrder 2,
photometric interpretations other than the four, grey at 2 or 4 bits or
with more than two samples, RGB below 8 bits or with more than four
samples, Palette at 2 or 16 bits. :func:`imread` raises ValueError for
these; ``io/video.py`` sends them to OpenCV where it is installed.
"""
from __future__ import annotations

import ctypes
import re
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

EXTENSIONS = (".png", ".bmp", ".jpg", ".jpeg", ".tif", ".tiff")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
_TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
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
    """Whether :func:`imread` decodes files of this name (PNG, BMP, JPEG,
    TIFF)."""
    return Path(str(path)).suffix.lower() in EXTENSIONS


def refused_variant(path) -> Optional[str]:
    """The name of the JPEG or TIFF variant `path` holds if :func:`imread`
    does not decode it, else None; read from the headers alone, never from
    a failed decode. PNG, BMP and files of no known format give None (the
    decoder raises for them)."""
    data = Path(path).read_bytes()
    if data.startswith(_JPEG_SIGNATURE):
        return _jpeg_parse(data, str(path)).refused
    if data[:4] in _TIFF_SIGNATURES:
        return _tiff_parse(data, str(path)).refused
    return None


def imread(path, color: bool = False) -> np.ndarray:
    """``cv2.imread(path, IMREAD_COLOR if color else IMREAD_GRAYSCALE)``
    of a PNG, BMP, JPEG or TIFF file: (h, w, 3) BGR or (h, w) grey uint8.
    Raises IOError for a file that is not a valid image of these formats
    and ValueError for a variant the port does not decode."""
    data = Path(path).read_bytes()
    name = str(path)
    if data.startswith(_PNG_SIGNATURE):
        return _decode_png(data, color, name)
    if data[:2] == b"BM":
        return _decode_bmp(data, color, name)
    if data.startswith(_JPEG_SIGNATURE):
        return _decode_jpeg(_jpeg_parse(data, name), data, color, name)
    if data[:4] in _TIFF_SIGNATURES:
        return _decode_tiff(_tiff_parse(data, name), data, color, name)
    raise IOError(f"{name}: not a PNG, BMP, JPEG or TIFF file")


def _refuse(name: str, variant: str):
    raise ValueError(f"{name}: {variant} is not decoded without OpenCV")


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


# --------------------------------------------------------------------------
# JPEG
# --------------------------------------------------------------------------

# zig-zag position -> natural (row-major) position in a block
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
_SOF_REFUSED = {
    0xC3: "JPEG lossless", 0xC5: "JPEG hierarchical",
    0xC6: "JPEG hierarchical", 0xC7: "JPEG hierarchical",
    0xC9: "JPEG arithmetic coding", 0xCA: "JPEG arithmetic coding",
    0xCB: "JPEG lossless", 0xCD: "JPEG hierarchical",
    0xCE: "JPEG hierarchical", 0xCF: "JPEG hierarchical"}
# the end of an entropy-coded segment: a marker that is no RSTn
_SEGMENT_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_SCAN_ERRORS = {-1: "a Huffman code no table holds",
                -2: "the data ends inside the scan",
                -3: "a missing or misplaced restart marker",
                -4: "a missing or invalid Huffman table"}


class _Jpeg:
    """A JPEG file's headers: the frame, each scan with the tables in force
    at its start, the colour markers and the EXIF orientation."""

    def __init__(self):
        self.refused: Optional[str] = None
        self.sof = None
        self.width = self.height = 0
        self.comps: list[dict] = []   # id, h, v, tq, q (latched)
        self.scans: list[dict] = []
        self.jfif = False
        self.adobe: Optional[int] = None
        self.orientation = 1


def _exif_orientation(body: bytes) -> int:
    """OpenCV's ExifReader on the first APP1 segment: the TIFF structure 6
    bytes in, IFD0's tag 0x0112 read as a 16-bit value; 1 where any of it
    is missing."""
    t = body[6:]
    if t[:2] == b"II":
        e = "<"
    elif t[:2] == b"MM":
        e = ">"
    else:
        return 1
    try:
        if struct.unpack(e + "H", t[2:4])[0] != 0x2A:
            return 1
        (off,) = struct.unpack(e + "I", t[4:8])
        (n,) = struct.unpack(e + "H", t[off:off + 2])
        for i in range(n):
            at = off + 2 + 12 * i
            (tag,) = struct.unpack(e + "H", t[at:at + 2])
            if tag == 0x0112:
                return struct.unpack(e + "H", t[at + 8:at + 10])[0]
    except struct.error:
        return 1
    return 1


def _jpeg_parse(data: bytes, name: str) -> _Jpeg:
    j = _Jpeg()
    quant: dict[int, np.ndarray] = {}
    huff = bytearray(8 * 273)
    present = 0
    restart = 0
    app1 = None
    pos = 2
    n = len(data)
    coef_bits = None
    while pos < n:  # a file cut short ends here: its scans decide
        if data[pos] != 0xFF:
            raise IOError(f"{name}: corrupt JPEG data: no marker at byte "
                          f"{pos}")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > n:
            raise IOError(f"{name}: truncated JPEG marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if length < 2 or len(body) != length - 2:
            raise IOError(f"{name}: truncated JPEG marker 0x{m:02X}")
        pos += length
        if m in _SOF_REFUSED or m == 0xDE:
            j.refused = j.refused or _SOF_REFUSED.get(m, "JPEG hierarchical")
        elif m == 0xCC:
            j.refused = j.refused or "JPEG arithmetic coding"
        elif m in (0xC0, 0xC1, 0xC2):
            if j.sof is not None:
                raise IOError(f"{name}: JPEG with two frame headers")
            _jpeg_frame(j, m, body, name)
            coef_bits = np.full((len(j.comps), 64), -1)
        elif m == 0xC4:
            at = 0
            while at < len(body):
                tc, th = body[at] >> 4, body[at] & 15
                counts = body[at + 1:at + 17]
                k = sum(counts)
                if tc > 1 or th > 3 or len(counts) != 16 or k > 256 \
                        or at + 17 + k > len(body):
                    raise IOError(f"{name}: invalid JPEG Huffman table")
                slot = 4 * tc + th
                huff[slot * 273:(slot + 1) * 273] = (
                    b"\x00" + counts + body[at + 17:at + 17 + k]).ljust(273,
                                                                        b"\0")
                present |= 1 << slot
                at += 17 + k
        elif m == 0xDB:
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or at + 1 + size > len(body):
                    raise IOError(f"{name}: invalid JPEG quantisation table")
                zz = np.frombuffer(body, ">u2" if pq else np.uint8, 64,
                                   at + 1).astype(np.uint16)
                table = np.zeros(64, np.uint16)
                table[_ZIGZAG] = zz
                quant[tq] = table
                at += 1 + size
        elif m == 0xDD:
            if len(body) < 2:
                raise IOError(f"{name}: invalid JPEG restart interval")
            (restart,) = struct.unpack(">H", body[:2])
        elif m == 0xE0:
            j.jfif = j.jfif or (len(body) >= 14 and body[:5] == b"JFIF\0")
        elif m == 0xE1:
            if app1 is None:
                app1 = body
        elif m == 0xEE:
            if len(body) >= 12 and body[:5] == b"Adobe" and j.adobe is None:
                j.adobe = body[11]
        elif m == 0xDA:
            if j.sof is None and j.refused is None:
                raise IOError(f"{name}: JPEG scan before the frame header")
            start = pos
            hit = _SEGMENT_END.search(data, start)
            pos = hit.start() if hit else n
            if j.refused is None:
                _jpeg_scan_header(j, body, bytes(huff), present, restart,
                                  quant, coef_bits, start, pos, name)
        # APPn, COM and others carry nothing the decode needs
    if j.sof is None and j.refused is None:
        raise IOError(f"{name}: JPEG without a frame header")
    if j.refused is None and not j.scans:
        raise IOError(f"{name}: JPEG without a scan")
    if j.refused is None and j.sof == 0xC2 and (coef_bits != 0).any():
        j.refused = ("JPEG progressive scans that leave coefficients "
                     "incomplete")
    if app1 is not None:
        j.orientation = _exif_orientation(app1)
    return j


def _jpeg_frame(j: _Jpeg, m: int, body: bytes, name: str):
    if len(body) < 6:
        raise IOError(f"{name}: truncated JPEG frame header")
    precision, height, width, nf = struct.unpack(">BHHB", body[:6])
    if len(body) < 6 + 3 * nf or nf == 0:
        raise IOError(f"{name}: truncated JPEG frame header")
    j.sof, j.width, j.height = m, width, height
    for i in range(nf):
        cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
        j.comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq, q=None))
    hmax = max(c["h"] for c in j.comps)
    vmax = max(c["v"] for c in j.comps)
    if width == 0:
        raise IOError(f"{name}: JPEG of width 0")
    if any(not 1 <= c["h"] <= 4 or not 1 <= c["v"] <= 4 or c["tq"] > 3
           for c in j.comps):
        raise IOError(f"{name}: invalid JPEG sampling factors or table")
    if precision != 8:
        j.refused = f"JPEG {precision}-bit precision"
    elif nf == 4:
        j.refused = "JPEG four components (CMYK, YCCK)"
    elif nf not in (1, 3):
        j.refused = f"JPEG {nf} components"
    elif height == 0:
        j.refused = "JPEG height from a DNL marker"
    elif any(hmax % c["h"] or vmax % c["v"] for c in j.comps):
        j.refused = "JPEG sampling factors that do not divide the largest"


def _jpeg_scan_header(j, body, huff, present, restart, quant, coef_bits,
                      start, end, name):
    ns = body[0] if body else 0
    if ns < 1 or ns > 4 or len(body) < 4 + 2 * ns:
        raise IOError(f"{name}: invalid JPEG scan header")
    index = {c["id"]: i for i, c in enumerate(j.comps)}
    comps, tables = [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i:3 + 2 * i]
        if cid not in index:
            raise IOError(f"{name}: JPEG scan of an unknown component")
        comps.append(index[cid])
        tables.append((t >> 4, t & 15))
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    progressive = j.sof == 0xC2
    if not progressive:
        ss, se, ah, al = 0, 63, 0, 0
    elif (ss == 0) != (se == 0) or se > 63 or ss > se or al > 13 \
            or (ss > 0 and ns != 1):
        raise IOError(f"{name}: invalid progressive JPEG scan {ss}-{se}, "
                      f"{ah}/{al}")
    if ns > 1 and sum(j.comps[c]["h"] * j.comps[c]["v"] for c in comps) > 10:
        raise IOError(f"{name}: JPEG MCU of more than 10 blocks")
    for c in comps:
        comp = j.comps[c]
        if comp["q"] is None:  # libjpeg latches the table at first use
            if comp["tq"] not in quant:
                raise IOError(f"{name}: JPEG without quantisation table "
                              f"{comp['tq']}")
            comp["q"] = quant[comp["tq"]].copy()
        coef_bits[c, ss:se + 1] = al
    j.scans.append(dict(comps=comps, tables=tables, ss=ss, se=se, ah=ah,
                        al=al, huff=huff, present=present, restart=restart,
                        start=start, end=end))


def jpeg_coefficients(j: _Jpeg, data: bytes, name: str) -> list:
    """Each component's quantised coefficients after every scan of `j`:
    (block rows, block columns, 64) int16 in natural order, the DC summed
    over its differences, over whole MCUs."""
    from ..ops.labeling import _lib

    lib = _lib()
    w, h = j.width, j.height
    hmax = max(c["h"] for c in j.comps)
    vmax = max(c["v"] for c in j.comps)
    mcus_x = -(-w // (8 * hmax))
    mcus_y = -(-h // (8 * vmax))
    coefs = [np.zeros((mcus_y * c["v"], mcus_x * c["h"], 64), np.int16)
             for c in j.comps]
    for sc in j.scans:
        info = []
        for c, (td, ta) in zip(sc["comps"], sc["tables"]):
            comp = j.comps[c]
            info += [comp["h"], comp["v"], td, ta, mcus_x * comp["h"],
                     -(-w * comp["h"] // (8 * hmax)),
                     -(-h * comp["v"] // (8 * vmax))]
        info = np.asarray(info, np.int32)
        ptrs = (ctypes.c_void_p * len(sc["comps"]))(
            *(coefs[c].ctypes.data for c in sc["comps"]))
        got = lib.trex_jpeg_scan(
            data, sc["end"], sc["start"], sc["huff"], sc["present"],
            len(sc["comps"]), info.ctypes.data_as(ctypes.POINTER(
                ctypes.c_int32)), ptrs, mcus_x, mcus_y,
            int(j.sof == 0xC2), sc["ss"], sc["se"], sc["ah"], sc["al"],
            sc["restart"])
        if got < 0:
            raise IOError(f"{name}: corrupt JPEG data: "
                          f"{_SCAN_ERRORS.get(got, got)}")
    return coefs


def _decode_jpeg(j: _Jpeg, data: bytes, color: bool,
                 name: str) -> np.ndarray:
    from ..ops.labeling import _lib

    if j.refused is not None:
        _refuse(name, j.refused)
    lib = _lib()
    w, h = j.width, j.height
    hmax = max(c["h"] for c in j.comps)
    vmax = max(c["v"] for c in j.comps)
    coefs = jpeg_coefficients(j, data, name)
    if len(j.comps) == 1:
        space = "grey"
    elif j.jfif:
        space = "ycc"
    elif j.adobe is not None:
        space = "rgb" if j.adobe == 0 else "ycc"
    elif [c["id"] for c in j.comps] == [82, 71, 66]:
        space = "rgb"
    else:
        space = "ycc"
    mode = {("grey", False): 0, ("ycc", False): 0, ("ycc", True): 1,
            ("rgb", True): 2, ("grey", True): 3, ("rgb", False): 4}[
        (space, color)]
    needed = j.comps[:1] if mode in (0, 3) else j.comps
    planes, info = [], []
    for comp in needed:
        if comp["q"] is None:  # a component no scan carried
            comp["q"] = np.zeros(64, np.uint16)
        bw = -(-w * comp["h"] // (8 * hmax))
        bh = -(-h * comp["v"] // (8 * vmax))
        plane = np.empty((bh * 8, bw * 8), np.uint8)
        coef = coefs[j.comps.index(comp)]
        lib.trex_jpeg_idct(
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), bw, bh,
            coef.shape[1], comp["q"].ctypes.data_as(ctypes.POINTER(
                ctypes.c_uint16)), plane.ctypes.data_as(ctypes.POINTER(
                    ctypes.c_uint8)), bw * 8)
        planes.append(plane)
        info += [bw * 8, -(-w * comp["h"] // hmax),
                 -(-h * comp["v"] // vmax), comp["h"], comp["v"]]
    out = np.empty((h, w, 3) if color else (h, w), np.uint8)
    info = np.asarray(info, np.int32)
    ptrs = (ctypes.c_void_p * len(planes))(*(p.ctypes.data for p in planes))
    if lib.trex_jpeg_output(
            ptrs, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(planes), hmax, vmax, w, h, mode,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))) != 0:
        raise IOError(f"{name}: invalid JPEG sampling factors")
    return _orient(out, j.orientation)


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ApplyExifOrientation: the flip or transpose of each EXIF
    orientation (2-8); other values leave the image as it is."""
    t = np.swapaxes
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
           4: lambda a: a[::-1], 5: lambda a: t(a, 0, 1),
           6: lambda a: t(a[::-1], 0, 1), 7: lambda a: t(a[::-1, ::-1], 0, 1),
           8: lambda a: t(a[:, ::-1], 0, 1)}
    if orientation not in ops:
        return img
    return np.ascontiguousarray(ops[orientation](img))


# --------------------------------------------------------------------------
# TIFF
# --------------------------------------------------------------------------

_TIFF_COMPRESSION = {
    2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
    6: "old-style JPEG", 7: "JPEG", 32809: "ThunderScan", 32946: None,
    34661: "JBIG", 34676: "SGI LogLuv", 34677: "SGI LogLuv",
    34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA", 50000: "ZSTD",
    50001: "WebP", 50002: "JPEG XL"}
_TIFF_PHOTOMETRIC = {4: "transparency mask", 5: "separated (CMYK)",
                     6: "YCbCr", 8: "CIE L*a*b*", 9: "ICC L*a*b*",
                     10: "ITU L*a*b*", 32844: "LogL", 32845: "LogLuv"}
# field type -> (struct code, bytes)
_TIFF_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
               6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4),
               16: ("Q", 8)}


class _Tiff:
    """The first IFD of a TIFF file, the fields the decode needs."""

    def __init__(self):
        self.refused: Optional[str] = None
        self.e = "<"
        self.tags: dict[int, tuple] = {}


def _tiff_parse(data: bytes, name: str) -> _Tiff:
    t = _Tiff()
    if data[2:4] in (b"+\x00", b"\x00+"):
        t.refused = "BigTIFF"
        return t
    t.e = e = "<" if data[:2] == b"II" else ">"
    try:
        (off,) = struct.unpack(e + "I", data[4:8])
        (n,) = struct.unpack(e + "H", data[off:off + 2])
        for i in range(n):
            at = off + 2 + 12 * i
            tag, typ, count = struct.unpack(e + "HHI", data[at:at + 8])
            if typ not in _TIFF_TYPES:
                continue
            code, size = _TIFF_TYPES[typ]
            where = at + 8
            if count * size > 4:
                (where,) = struct.unpack(e + "I", data[at + 8:at + 12])
            raw = data[where:where + count * size]
            if len(raw) != count * size:
                raise IOError(f"{name}: TIFF tag {tag} past the end")
            t.tags[tag] = struct.unpack(e + code * count, raw)
    except struct.error as err:
        raise IOError(f"{name}: truncated TIFF directory") from err
    get = lambda tag, default: t.tags.get(tag, (default,))  # noqa: E731
    bps = get(258, 1)
    spp = get(277, 1)[0]
    comp = get(259, 1)[0]
    photometric = t.tags.get(262, (None,))[0]
    # libtiff reads the predictor only with the codecs that take one
    pred = get(317, 1)[0] if comp in (5, 8, 32946) else 1
    fmt = set(get(339, 1))
    if 256 not in t.tags or 257 not in t.tags:
        raise IOError(f"{name}: TIFF without image size")
    if comp not in (1, 5, 8, 32946, 32773):
        t.refused = f"TIFF {_TIFF_COMPRESSION.get(comp) or comp} compression"
    elif photometric is None:
        t.refused = "TIFF without PhotometricInterpretation"
    elif photometric not in (0, 1, 2, 3):
        t.refused = (f"TIFF photometric "
                     f"{_TIFF_PHOTOMETRIC.get(photometric, photometric)}")
    elif fmt - {1}:
        t.refused = ("TIFF floating-point samples" if 3 in fmt
                     else "TIFF signed samples" if 2 in fmt
                     else f"TIFF sample format {sorted(fmt)}")
    elif len(set(bps)) != 1:
        t.refused = "TIFF samples of different bit depths"
    elif get(284, 1)[0] != 1:
        t.refused = "TIFF separate planes (PlanarConfiguration 2)"
    elif get(274, 1)[0] != 1:
        t.refused = f"TIFF orientation {get(274, 1)[0]}"
    elif get(266, 1)[0] != 1:
        t.refused = "TIFF FillOrder 2"
    elif pred == 3:
        t.refused = "TIFF floating-point predictor"
    elif pred not in (1, 2):
        t.refused = f"TIFF predictor {pred}"
    elif pred == 2 and bps[0] not in (8, 16):
        t.refused = f"TIFF predictor 2 at {bps[0]} bits"
    else:
        b = bps[0]
        kind = {0: "grey", 1: "grey", 2: "RGB", 3: "palette"}[photometric]
        bits, samples = {0: ((1, 8, 16), (1, 2)), 1: ((1, 8, 16), (1, 2)),
                         2: ((8, 16), (3, 4)), 3: ((1, 4, 8), (1,))}[
            photometric]
        if b not in bits:
            t.refused = f"TIFF {b}-bit {kind}"
        elif spp not in samples or (b == 1 and spp != 1):
            t.refused = f"TIFF {b}-bit {kind} with {spp} samples"
        elif photometric == 3 and 320 not in t.tags:
            t.refused = "TIFF palette without a colour map"
    if t.refused is None and not ((273 in t.tags and 279 in t.tags) or (
            322 in t.tags and 323 in t.tags and 324 in t.tags
            and 325 in t.tags)):
        raise IOError(f"{name}: TIFF without strips or tiles")
    return t


def _decode_tiff(t: _Tiff, data: bytes, color: bool,
                 name: str) -> np.ndarray:
    from ..ops.labeling import _lib

    if t.refused is not None:
        _refuse(name, t.refused)
    tags, e = t.tags, t.e
    w, h = tags[256][0], tags[257][0]
    bps = tags.get(258, (1,))[0]
    spp = tags.get(277, (1,))[0]
    comp = tags.get(259, (1,))[0]
    pred = tags.get(317, (1,))[0] if comp in (5, 8, 32946) else 1
    if w == 0 or h == 0:
        raise IOError(f"{name}: TIFF of size {w}x{h}")
    tiled = 322 in tags
    if tiled:
        cw, ch = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        nx, ny = -(-w // cw), -(-h // ch)
        rows = [ch] * (nx * ny)
    else:
        cw, ch = w, min(tags.get(278, (2 ** 32 - 1,))[0], h) or h
        offsets, counts = tags[273], tags[279]
        rows = [min(ch, h - y) for y in range(0, h, ch)]
    if cw == 0 or len(offsets) < len(rows) or len(counts) < len(rows):
        raise IOError(f"{name}: TIFF with {len(offsets)} strips or tiles, "
                      f"not {len(rows)}")
    row_bytes = -(-cw * spp * bps // 8)
    sizes = np.asarray(rows, np.int64) * row_bytes
    buf = np.empty(int(sizes.sum()), np.uint8)
    kind = {1: "uncompressed", 5: "LZW", 32773: "PackBits"}.get(comp,
                                                                "Deflate")
    if comp in (8, 32946):
        at = 0
        for off, count, size in zip(offsets, counts, sizes):
            try:
                got = zlib.decompressobj().decompress(
                    data[off:off + count], int(size))
            except zlib.error as err:
                raise IOError(f"{name}: corrupt Deflate TIFF data ({err})") \
                    from err
            if len(got) < size:
                raise IOError(f"{name}: Deflate TIFF strip too short")
            buf[at:at + size] = np.frombuffer(got, np.uint8)
            at += size
    else:
        n = len(rows)
        offs = np.asarray(offsets[:n], np.int64)
        cnts = np.asarray(counts[:n], np.int64)
        bad = _lib().trex_tiff_chunks(
            data, len(data), offs.ctypes.data_as(_I64P),
            cnts.ctypes.data_as(_I64P), sizes.ctypes.data_as(_I64P), n,
            comp, buf.ctypes.data_as(_U8P))
        if bad >= 0:
            raise IOError(f"{name}: {kind} TIFF strip or tile {bad} is "
                          f"corrupt or lies past the end")
    if pred == 2:
        _lib().trex_tiff_predict(buf.ctypes.data_as(_U8P), len(buf) //
                                 row_bytes, cw, spp, bps, int(e == ">"))
    lines = buf.reshape(-1, row_bytes)
    if bps >= 8:
        dtype = np.dtype(e + "u2") if bps == 16 else np.dtype(np.uint8)
        s = lines.view(dtype).reshape(-1, cw, spp)
        s = s.astype(np.uint16) if bps == 16 else s
    else:
        bits = np.unpackbits(lines, axis=1)[:, :cw * spp * bps]
        s = (bits.reshape(-1, cw, spp, bps) * (1 << np.arange(
            bps - 1, -1, -1, dtype=np.uint8))).sum(axis=3, dtype=np.uint8)
    if tiled:
        s = s.reshape(ny, nx, ch, cw, spp)
        vw = w - (nx - 1) * cw
        # libtiff's put16bitbwtile, and putgreytile and putagreytile with
        # two samples, step a row of a tile cut by the right edge by the
        # hidden pixels' count in bytes, not in pixels: its rows after the
        # first are read from those offsets (a cut tile of visible width
        # v, a pixel of p bytes: row r starts at byte r * (v * p + tw - v))
        if tags[262][0] in (0, 1) and (bps == 16 or spp == 2) and vw < cw:
            cut = _skewed_tile(s[:, -1], vw)
            s = np.concatenate([s[:, :-1].transpose(0, 2, 1, 3, 4).reshape(
                ny, ch, (nx - 1) * cw, spp), cut], axis=2)
        else:
            s = s.transpose(0, 2, 1, 3, 4).reshape(ny, ch, nx * cw, spp)
        s = s.reshape(ny * ch, -1, spp)
    return _tiff_output(s[:h, :w], t, color)


def _skewed_tile(s: np.ndarray, vw: int) -> np.ndarray:
    """The (ny, rows, vw, spp) samples libtiff's grey tile readers take
    from the (ny, rows, tw, spp) tiles of the right edge, cut at width `vw`
    (see :func:`_decode_tiff`)."""
    ny, rows, tw, spp = s.shape
    size = s.dtype.itemsize
    flat = np.ascontiguousarray(s.astype(f"<u{size}")).view(
        np.uint8).reshape(ny, -1)
    pixel = spp * size
    at = (np.arange(rows) * (vw * pixel + tw - vw))[:, None, None] \
        + (np.arange(vw) * pixel)[None, :, None] \
        + (np.arange(spp) * size)[None, None, :]
    if size == 1:
        return flat[:, at]
    return flat[:, at] | (flat[:, at + 1].astype(np.uint16) << 8)


def _tiff_output(s: np.ndarray, t: _Tiff, color: bool) -> np.ndarray:
    """libtiff's TIFFRGBAImage conversion of the samples to 8-bit RGB, then
    OpenCV's RGBA to BGR or to grey."""
    tags = t.tags
    bps = tags.get(258, (1,))[0]
    photometric = tags[262][0]
    if photometric in (0, 1):
        v = s[..., 0]
        if bps == 16:
            v = (v >> 8).astype(np.uint8)
        elif bps == 1:
            v = v * np.uint8(255)
        if photometric == 0:
            v = 255 - v
        if not color:
            return np.ascontiguousarray(v)
        return np.repeat(v[..., None], 3, axis=2)
    if photometric == 3:
        cmap = np.asarray(tags[320], np.uint16).reshape(3, -1)
        cmap = cmap[:, :1 << bps]
        if (cmap >= 256).any():
            cmap = cmap >> 8
        rgb = cmap.astype(np.uint8).T[s[..., 0]]
    else:
        rgb = s[..., :3]
        if bps == 16:
            rgb = ((rgb.astype(np.uint32) + 128) // 257).astype(np.uint8)
        if s.shape[2] == 4 and tags.get(338, (None,))[0] == 2:
            a = s[..., 3:].astype(np.uint32)
            if bps == 16:
                a = (a + 128) // 257
            rgb = ((rgb * a + 127) // 255).astype(np.uint8)
    if color:
        return np.ascontiguousarray(rgb[..., ::-1])
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((b * _BMP_CB + g * _BMP_CG + r * _BMP_CR + (1 << 13)) >> 14
            ).astype(np.uint8)
