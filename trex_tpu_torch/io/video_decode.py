"""Video files without OpenCV (the machine with the card has none):
:class:`VideoFile` gives the frames ``cv2.VideoCapture(path).read()`` of
OpenCV 5.0.0 gives, in BGR, and in grey as ``cvtColor(COLOR_BGR2GRAY)``
of them (``tests/test_torch_video_decode.py`` holds it to cv2 bit for
bit), with the ``CAP_PROP_FRAME_COUNT`` and ``CAP_PROP_FPS`` it reports.

The container (``io/containers.py``): MP4, MOV or M4V (ISO BMFF) and AVI.
The codec, as OpenCV's FFmpeg (libavcodec 62.28, libswscale 9.5) decodes
it on an x86-64 host:

- MPEG-4 Part 2 (``mp4v`` in MP4 or AVI, ``XVID``, ``DIVX``, ``DX50`` and
  ``FMP4`` in AVI): FFmpeg's ``mpeg4`` decoder on rectangular progressive
  streams with H.263 quantisation, I- and P-VOPs (``native/mpeg4video.cpp``),
  then libswscale's ``yuv420p`` (limited range) to ``bgr24``.
- MJPEG (``MJPG`` in AVI): baseline
  Huffman JPEG, 4:2:0, entropy-decoded by ``native/jpeg.cpp``, then
  FFmpeg's ``mjpeg`` dequantisation and simple IDCT and libswscale's
  ``yuvj420p`` (full range) to ``bgr24``.
- Raw AVI: ``I420``/``IYUV``/``YV12`` planes (as above, limited range);
  what cv2 writes under fourcc 0 is ``I420``.

Reading frame after frame decodes the next frame; a jump decodes from the
key frame at or before the index, as cv2's seek ends up doing. What the
port does not decode is named from the headers alone by
:func:`refused_variant` (never from a failed decode): other containers and
codecs (H.264, HEVC...), and of MPEG-4 Part 2 B-VOPs, S-VOPs and sprites,
quarter-pel, interlace, data partitioning, MPEG quantisation, short
headers, OBMC, other shapes, depths and chroma formats, VOPs that are not
coded, a VOL whose size is not the container's, Xvid and DivX builds and
old libavcodec builds (whose workarounds and IDCT FFmpeg switches on), an
edit list that moves the first frame; of every codec an odd frame height
(cv2's writer writes none; libswscale converts one by its scaler, not by
the unscaled path rebuilt here);
of MJPEG progressive, lossless or arithmetic coding and sampling other than
4:2:0; raw formats other than these (an RGB DIB among them, which
cv2 5.0.0 itself reads with a corrupted heap). ``io/video.py`` sends these to
OpenCV where it is installed.
"""
from __future__ import annotations

import ctypes
import re
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from .containers import Container, open_container

EXTENSIONS = (".mp4", ".mov", ".m4v", ".avi")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
# the fourccs cv2's VideoWriter writes these codecs under
_MPEG4 = ("mp4v", "XVID", "DIVX", "DX50", "FMP4")
_MJPEG = ("MJPG",)
_RAW_YUV = ("I420", "IYUV", "YV12")
# codec tags that make FFmpeg assume an Xvid or DivX 4 encoder when the
# stream carries no encoder user data (ff_mpeg4_workaround_bugs)
_XVID_TAGS = ("XVID", "XVIX", "RMP4", "ZMP4", "SIPP")
_NAMES = {"avc1": "H.264", "avc3": "H.264", "H264": "H.264",
          "h264": "H.264", "hvc1": "HEVC", "hev1": "HEVC", "HEVC": "HEVC",
          "av01": "AV1", "vp09": "VP9", "VP90": "VP9", "VP80": "VP8"}
_M4V_ERRORS = {-1: "a code no table holds, or data that ran out",
               -2: "a broken header", -4: "a P-VOP without a picture "
               "before it", -5: "a broken video packet header",
               -6: "a picture of another size than the container's"}
# what native/mpeg4video.cpp's headers name (its kWhy* codes) and the
# decoder does not decode
_M4V_REFUSED = {
    1: "a chroma format other than 4:2:0",
    2: "a shape other than rectangular",
    3: "a time increment resolution of 0",
    4: "interlaced video",
    5: "overlapped block motion compensation",
    6: "sprites (S-VOPs, global motion compensation)",
    7: "a sample depth other than 8 bits",
    8: "MPEG quantisation matrices",
    9: "quarter-pel motion",
    10: "complexity estimation headers",
    11: "data partitioning",
    12: "NEWPRED",
    13: "reduced-resolution VOPs",
    14: "scalability",
    15: "B-VOPs",
    16: "S-VOPs (sprites, global motion compensation)",
    17: "VOPs that are not coded",
    18: "a VOP before any VOL header",
    19: "short video headers (H.263)",
    20: "a video signal type in the visual object header",
}
_M4V_UNSUPPORTED = -3


def can_decode(path) -> bool:
    """Whether :class:`VideoFile` takes files of this name."""
    return Path(str(path)).suffix.lower() in EXTENSIONS


def refused_variant(path) -> Optional[str]:
    """The name of what `path` holds if :class:`VideoFile` does not decode
    it, else None; read from the container's and the stream's headers,
    never from a failed decode."""
    return probe(path).refused


def probe(path) -> "_Stream":
    """Read `path`'s headers once: its container and, as ``refused``, the
    name of what :class:`VideoFile` does not decode in it (or None). A
    :class:`VideoFile` of the same path takes the result."""
    return _Stream(path)


class _Stream:
    """The container plus what its codec needs; `refused` names what the
    port does not decode."""

    def __init__(self, path):
        self.c = self.kind = None
        with open(path, "rb") as fh:
            head = fh.read(12)
        if not (head[:4] == b"RIFF" and head[8:12] == b"AVI ") and \
                head[4:8] not in (b"ftyp", b"moov", b"mdat", b"free",
                                  b"wide", b"skip"):
            self.refused = "a container other than MP4/MOV and AVI"
            return
        self.c = c = open_container(path)
        self.refused = c.refused
        tag = c.codec
        if tag in _MPEG4:
            self.kind = "mpeg4"
            if self.refused is None:
                self.refused = _mpeg4_refusal(c)
        elif tag in _MJPEG and c.format == "avi":
            self.kind = "mjpeg"
        elif tag in _RAW_YUV and c.format == "avi":
            self.kind = "yuv"
        elif tag == "raw" and c.format == "avi":
            self.refused = f"a raw {c.bit_count}-bit RGB DIB AVI"
        else:
            name = _NAMES.get(tag, tag)
            self.refused = f"{name} video" + (f" ({tag})" if name != tag
                                              else "")
        if self.kind == "mjpeg" and self.refused is None:
            self.refused = _mjpeg_refusal(c)
        if self.kind and self.refused is None and c.height % 2:
            self.refused = (f"an odd frame height ({c.height}), which "
                            f"libswscale converts to BGR by another path")


class VideoFile:
    """One video file, decoded without OpenCV. Raises ValueError for a
    variant :func:`refused_variant` names and IOError for a broken file."""

    def __init__(self, path, stream: Optional[_Stream] = None):
        self.path = str(path)
        s = stream if stream is not None else _Stream(self.path)
        if s.refused is not None:
            raise ValueError(f"{self.path}: {s.refused} is not decoded "
                             f"without OpenCV")
        self._c = s.c
        self._kind = s.kind
        self._fh = open(self.path, "rb")
        self._next = 0  # the index the decoder state is ready for
        self._dec = None
        self._planes = None
        # (index, (y, u, v, full range)) of the latest decode
        self._last = None
        if self._kind == "mpeg4":
            from ..ops.labeling import _lib

            self._lib = _lib()
            self._dec = self._lib.trex_m4v_new(0)
            x = self._c.extradata
            info = np.zeros(6, np.int32)
            if x and self._lib.trex_m4v_headers(
                    self._dec, x, len(x), info.ctypes.data_as(_I32P)) != 0:
                raise IOError(f"{self.path}: broken MPEG-4 headers")
            self._keys = np.flatnonzero(self._c.keyframes)

    def __len__(self) -> int:
        """``CAP_PROP_FRAME_COUNT``: the count the container states."""
        return int(self._c.frame_count)

    @property
    def frame_rate(self) -> float:
        """``CAP_PROP_FPS``."""
        return float(self._c.fps)

    def read(self, index: int, color: bool) -> np.ndarray:
        """Frame `index`: (h, w, 3) BGR or (h, w) grey uint8."""
        if not 0 <= index < len(self._c):
            raise IndexError(index)
        if self._last is None or self._last[0] != index:
            self._last = (index, self._decode(index))
        return yuv420_bgr(*self._last[1], grey=not color)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._dec:
            self._lib.trex_m4v_free(self._dec)
            self._dec = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- decoding -------------------------------------------------------

    def _decode(self, index: int) -> tuple:
        """Frame `index`'s planes and range: (y, u, v, full_range)."""
        c = self._c
        if self._kind == "mjpeg":
            return _mjpeg_planes(c.read(self._fh, index), self.path)
        if self._kind == "yuv":
            return _yuv_planes(c, c.read(self._fh, index), self.path)
        start = self._next
        # the key frame at or before `index`; decoding on from the state
        # already reached gives the same picture when no key frame lies
        # between
        k = self._keys[self._keys <= index]
        key = int(k[-1]) if k.size else 0
        if not (key < start <= index):
            self._lib.trex_m4v_flush(self._dec)
            start = key
        for i in range(start, index + 1):
            self._mpeg4_packet(i)
        self._next = index + 1
        return (*self._planes, 0)

    def _mpeg4_packet(self, i: int):
        c = self._c
        w, h = c.width, c.height
        if self._planes is None:
            cw, ch = (w + 1) // 2, (h + 1) // 2
            self._planes = (np.zeros((h, w), np.uint8),
                            np.zeros((ch, cw), np.uint8),
                            np.zeros((ch, cw), np.uint8))
        y, u, v = self._planes
        pkt = c.read(self._fh, i)
        info = np.zeros(6, np.int32)
        r = self._lib.trex_m4v_decode(
            self._dec, pkt, len(pkt), y.ctypes.data_as(_U8P), y.shape[1],
            u.ctypes.data_as(_U8P), v.ctypes.data_as(_U8P), u.shape[1],
            w, h, info.ctypes.data_as(_I32P))
        if r == _M4V_UNSUPPORTED:
            why = _M4V_REFUSED.get(int(info[5]), int(info[5]))
            raise IOError(f"{self.path}: frame {i}: MPEG-4 Part 2 with {why}"
                          f", which its earlier headers did not announce")
        if r != 0:
            raise IOError(f"{self.path}: frame {i}: corrupt MPEG-4 data "
                          f"({_M4V_ERRORS.get(r, r)}"
                          + (f": {info[0]}x{info[1]}, the container says "
                             f"{w}x{h}" if r == -6 else "") + ")")


def yuv420_bgr(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               full_range: int, grey: bool = False) -> np.ndarray:
    """libswscale's unscaled yuv420p (or, full range, yuvj420p) to bgr24:
    (h, w, 3); with `grey`, ``cvtColor(COLOR_BGR2GRAY)`` of it, (h, w)."""
    from ..ops.labeling import _lib

    h, w = y.shape
    out = np.empty((h, w) if grey else (h, w, 3), np.uint8)
    _lib().trex_yuv420_bgr(
        y.ctypes.data_as(_U8P), y.strides[0], u.ctypes.data_as(_U8P),
        u.strides[0], v.ctypes.data_as(_U8P), v.strides[0], w, h,
        int(full_range), int(grey), out.ctypes.data_as(_U8P))
    return out


# --------------------------------------------------------------------------
# Raw AVI
# --------------------------------------------------------------------------

def _yuv_planes(c: Container, pkt: bytes, name: str) -> tuple:
    w, h = c.width, c.height
    cw, ch = (w + 1) // 2, (h + 1) // 2
    n = w * h + 2 * cw * ch
    if len(pkt) < n:
        raise IOError(f"{name}: a raw frame of {len(pkt)} bytes, {n} "
                      f"expected")
    a = np.frombuffer(pkt, np.uint8, n)
    y = a[:w * h].reshape(h, w)
    p1 = a[w * h:w * h + cw * ch].reshape(ch, cw)
    p2 = a[w * h + cw * ch:].reshape(ch, cw)
    u, v = (p2, p1) if c.codec == "YV12" else (p1, p2)
    return y, u, v, 0


# --------------------------------------------------------------------------
# MJPEG
# --------------------------------------------------------------------------

def _mjpeg_refusal(c: Container) -> Optional[str]:
    """MJPEG variants from the first frame's markers up to its frame
    header."""
    if not len(c):
        return None
    with open(c.path, "rb") as fh:
        return _mjpeg_check(c.read(fh, 0))


_SOF_NAMES = {0xC2: "progressive", 0xC3: "lossless", 0xC6: "progressive",
              0xC7: "lossless", 0xCA: "progressive", 0xCB: "lossless",
              0xCE: "progressive", 0xCF: "lossless"}


def _mjpeg_check(pkt: bytes) -> Optional[str]:
    """The name of an MJPEG frame's variant the port does not decode:
    anything but baseline or extended sequential Huffman coding of 8-bit
    YCbCr 4:2:0."""
    pos = 2
    while pos + 4 <= len(pkt):
        if pkt[pos] != 0xFF:
            return None  # the decoder reports the broken frame
        m = pkt[pos + 1]
        if m == 0xFF:
            pos += 1
            continue
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            pos += 2
            continue
        (length,) = struct.unpack(">H", pkt[pos + 2:pos + 4])
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            kind = _SOF_NAMES.get(m, "sequential")
            if m >= 0xC5:
                kind = "hierarchical " + kind if m in (0xC5, 0xC6, 0xC7,
                                                        0xCD, 0xCE, 0xCF) \
                    else kind
            if m >= 0xC9:
                kind += " arithmetic-coded"
            if m not in (0xC0, 0xC1):
                return f"{kind} MJPEG"
            body = pkt[pos + 4:pos + 2 + length]
            if body[0] != 8:
                return f"{body[0]}-bit MJPEG"
            hv = [(b >> 4, b & 15) for b in body[7::3][:body[5]]]
            if hv != [(2, 2), (1, 1), (1, 1)]:
                return f"MJPEG with sampling {hv} (other than 4:2:0)"
            return None
        if m == 0xDA:
            return None
        pos += 2 + length
    return None


def _mjpeg_planes(pkt: bytes, name: str) -> tuple:
    from ..ops.labeling import _lib
    from .image_decode import _jpeg_parse, jpeg_coefficients

    variant = _mjpeg_check(pkt)
    if variant is not None:
        raise ValueError(f"{name}: {variant} is not decoded without OpenCV")
    j = _jpeg_parse(pkt, name)
    if j.sof is None:
        raise IOError(f"{name}: MJPEG frame without a frame header")
    coefs = jpeg_coefficients(j, pkt, name)
    lib = _lib()
    w, h = j.width, j.height
    planes = []
    for comp, coef in zip(j.comps, coefs):
        if comp["q"] is None:
            comp["q"] = np.zeros(64, np.uint16)
        q = np.ascontiguousarray(comp["q"], np.uint16)
        bh, bw = coef.shape[:2]
        plane = np.empty((bh * 8, bw * 8), np.uint8)
        lib.trex_mjpeg_idct(
            coef.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), bw, bh, bw,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            plane.ctypes.data_as(_U8P), bw * 8)
        planes.append(plane)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return planes[0][:h, :w], planes[1][:ch, :cw], planes[2][:ch, :cw], 1


# --------------------------------------------------------------------------
# MPEG-4 Part 2 headers
# --------------------------------------------------------------------------

def _start_codes(data: bytes):
    """(code, offset after it) of each 00 00 01 xx start code."""
    at = data.find(b"\x00\x00\x01")
    while 0 <= at < len(data) - 3:
        yield data[at + 3], at + 4
        at = data.find(b"\x00\x00\x01", at + 3)


class _Encoder:
    """The encoder builds the stream's user data names (-1: none)."""

    def __init__(self):
        self.lavc = self.xvid = self.divx = -1

    def read(self, data: bytes):
        """The user data of `data` up to its VOP, as FFmpeg's
        decode_user_data reads it."""
        for code, at in _start_codes(data):
            if code == 0xB6:
                return
            if code != 0xB2:
                continue
            end = data.find(b"\x00\x00\x01", at)
            text = data[at:end if end >= 0 else len(data)][:255]
            t = text.split(b"\x00")[0].decode("latin-1")
            m = re.match(r"DivX(\d+)(Build|b)(\d+)", t)
            if m:
                self.divx = int(m.group(1))
            m = re.match(r"Lavc(\d+)\.(\d+)\.(\d+)", t)
            if m and all(int(g) <= 255 for g in m.groups()):
                self.lavc = (int(m.group(1)) << 16) + \
                    (int(m.group(2)) << 8) + int(m.group(3))
            if t == "ffmpeg":
                self.lavc = 4600
            m = re.match(r"XviD(\d+)", t)
            if m:
                self.xvid = int(m.group(1))


def _mpeg4_refusal(c: Container) -> Optional[str]:
    """The MPEG-4 Part 2 features the port does not decode, from the VOL,
    VO and VOP headers (``native/mpeg4video.cpp``'s own parser, reading
    the head of every packet) and the user data of the extradata and of
    every packet."""
    from ..ops.labeling import _lib

    lib = _lib()
    probe = lib.trex_m4v_new(1)
    info = np.zeros(6, np.int32)
    enc = _Encoder()

    def scan(data: bytes) -> Optional[str]:
        r = lib.trex_m4v_headers(probe, data, len(data),
                                 info.ctypes.data_as(_I32P))
        if r == _M4V_UNSUPPORTED:
            return _M4V_REFUSED[int(info[5])]
        # a broken header is the decoder's to report
        if info[2] and (int(info[0]), int(info[1])) != (c.width, c.height):
            return f"a VOL of {info[0]}x{info[1]} in a {c.width}x" \
                   f"{c.height} container"
        enc.read(data)
        return None

    try:
        r = scan(c.extradata) if c.extradata else None
        with open(c.path, "rb") as fh:
            for i in range(len(c) if r is None else 0):
                fh.seek(int(c.offsets[i]))
                seen = bool(info[2])
                r = scan(fh.read(min(int(c.sizes[i]), 512)))
                if r is None and not (seen or info[2]):
                    r = "no VOL header"
                if r is not None:
                    break
    finally:
        lib.trex_m4v_free(probe)
    if r is not None:
        return f"MPEG-4 Part 2 with {r}"
    tag = c.codec
    if tag in ("XVIX", "UMP4", "3IV1", "3IV2"):
        return f"MPEG-4 Part 2 tagged {tag}"
    if enc.xvid == -1 and enc.divx == -1 and enc.lavc == -1:
        if tag in _XVID_TAGS:
            enc.xvid = 0
        elif tag == "DIVX" and info[3] == 0 and info[4] == 0:
            enc.divx = 400
    if enc.xvid >= 0:
        return f"an Xvid stream (build {enc.xvid})"
    if enc.divx >= 0:
        return f"a DivX stream (version {enc.divx})"
    if 0 <= enc.lavc <= 4712 or 3621476 < enc.lavc < 3752552:
        return f"an old libavcodec stream (build {enc.lavc})"
    return None
