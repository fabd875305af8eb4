"""Video containers without OpenCV: the demuxers of ``io/video_decode.py``.

Two formats, read as FFmpeg's demuxers in OpenCV 5.0.0 read them:

- ISO BMFF (MP4, MOV, M4V): ``moov``/``trak``/``mdia``/``minf``/``stbl``
  of the first video track. The sample table (``stsz``, ``stsc``,
  ``stco``/``co64``) gives each frame's packet, ``stss`` the key frames
  (every frame where it is absent), ``stts`` with ``mdhd``'s timescale
  the frame rate, ``stsd`` the codec and its ``esds``
  DecoderSpecificInfo (for ``mp4v``, the VOS/VOL headers). An edit list
  of one entry that starts at the first sample is accepted; any other
  (a delay, a cut) is refused by name, since it changes which frames
  OpenCV returns.
- RIFF AVI: ``hdrl``/``avih``/``strh``/``strf`` of the first video
  stream (BITMAPINFOHEADER), the
  stream's ``##dc``/``##db`` chunks in every ``movi`` list, those of the
  OpenDML ``AVIX`` extensions included, in file order. Key frames come
  from ``idx1``'s flags or, where the file has them, the OpenDML
  ``ix##`` standard indexes; with neither, every frame is a key frame.

:func:`open_container` returns a :class:`Container`; ``frame_count`` and
``fps`` are what ``CAP_PROP_FRAME_COUNT`` and ``CAP_PROP_FPS`` report.

:class:`Mp4Writer` writes the other way: one ``mp4v`` track, streamed
(``io/video_encode.py`` feeds it).
"""
from __future__ import annotations

import struct
from array import array
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Container:
    """One video stream of a file: where each frame's packet lies."""

    path: str
    format: str  # "mp4" or "avi"
    codec: str  # sample entry or fourcc: "mp4v", "XVID", "MJPG", ...
    width: int
    height: int
    offsets: np.ndarray  # (n,) int64 byte offset of each packet
    sizes: np.ndarray  # (n,) int64
    keyframes: np.ndarray  # (n,) bool
    frame_count: int
    fps: float
    extradata: bytes = b""
    bit_count: int = 0  # AVI: BITMAPINFOHEADER.biBitCount
    refused: Optional[str] = None

    def __len__(self) -> int:
        return int(self.offsets.size)

    def read(self, fh, index: int) -> bytes:
        """Frame `index`'s packet from the open file `fh`."""
        fh.seek(int(self.offsets[index]))
        data = fh.read(int(self.sizes[index]))
        if len(data) != int(self.sizes[index]):
            raise IOError(f"{self.path}: packet {index} is cut short")
        return data


def open_container(path) -> Container:
    """Parse the container of `path`. Raises IOError for a file that is
    neither an ISO BMFF nor an AVI file, or whose tables are broken."""
    path = str(path)
    with open(path, "rb") as fh:
        head = fh.read(12)
        if len(head) == 12 and head[:4] == b"RIFF" and head[8:12] in (
                b"AVI ", b"AVIX"):
            return _avi(path, fh)
        if len(head) >= 8 and head[4:8] in (b"ftyp", b"moov", b"mdat",
                                              b"free", b"wide", b"skip"):
            return _mp4(path, fh)
    raise IOError(f"{path}: not an MP4/MOV or AVI file")


# --------------------------------------------------------------------------
# ISO BMFF
# --------------------------------------------------------------------------

def _boxes(fh, start: int, end: int):
    """(type, body offset, body size) of the boxes in [start, end)."""
    pos = start
    while pos + 8 <= end:
        fh.seek(pos)
        hdr = fh.read(16)
        if len(hdr) < 8:
            return
        size, kind = struct.unpack(">I4s", hdr[:8])
        head = 8
        if size == 1:
            if len(hdr) < 16:
                return
            (size,) = struct.unpack(">Q", hdr[8:16])
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise IOError(f"broken box {kind!r} at {pos}")
        yield kind, pos + head, size - head
        pos += size


def _child(fh, start, size, kind):
    for k, off, n in _boxes(fh, start, start + size):
        if k == kind:
            return off, n
    return None


def _body(fh, loc) -> bytes:
    fh.seek(loc[0])
    return fh.read(loc[1])


def _descriptor(data: bytes, pos: int):
    """(tag, body start, body size) of an MPEG-4 descriptor."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, size


def _esds_config(esds: bytes) -> bytes:
    """The DecoderSpecificInfo of an ``esds`` box body."""
    tag, pos, _ = _descriptor(esds, 4)  # after version and flags
    if tag != 0x03:
        return b""
    pos += 2  # ES_ID
    flags = esds[pos]
    pos += 1
    if flags & 0x80:
        pos += 2
    if flags & 0x40:
        pos += 1 + esds[pos]
    if flags & 0x20:
        pos += 2
    tag, pos, size = _descriptor(esds, pos)
    if tag != 0x04:
        return b""
    end = pos + size
    pos += 13
    while pos < end:
        tag, body, size = _descriptor(esds, pos)
        if tag == 0x05:
            return esds[body:body + size]
        pos = body + size
    return b""


def _mp4(path: str, fh) -> Container:
    fh.seek(0, 2)
    end = fh.tell()
    moov = _child(fh, 0, end, b"moov")
    if moov is None:
        raise IOError(f"{path}: MP4 without a moov box")
    for kind, off, size in _boxes(fh, *_span(moov)):
        if kind != b"trak":
            continue
        mdia = _child(fh, off, size, b"mdia")
        if mdia is None:
            continue
        hdlr = _body(fh, _child(fh, *mdia, b"hdlr") or (0, 0))
        if hdlr[8:12] != b"vide":
            continue
        return _mp4_track(path, fh, (off, size), mdia)
    raise IOError(f"{path}: MP4 without a video track")


def _span(loc):
    return loc[0], loc[0] + loc[1]


def _full(data: bytes, fmt: str, at: int = 4):
    return struct.unpack_from(">" + fmt, data, at)


def _mp4_track(path, fh, trak, mdia) -> Container:
    mdhd = _body(fh, _child(fh, *mdia, b"mdhd"))
    timescale = _full(mdhd, "I", 20 if mdhd[0] == 1 else 12)[0]
    minf = _child(fh, *mdia, b"minf")
    stbl = _child(fh, *minf, b"stbl") if minf else None
    if stbl is None:
        raise IOError(f"{path}: MP4 track without a sample table")

    def table(kind):
        loc = _child(fh, *stbl, kind)
        return None if loc is None else _body(fh, loc)

    stsd = table(b"stsd")
    entry = stsd[8:]
    (esize, codec) = struct.unpack(">I4s", entry[:8])
    width, height = struct.unpack(">HH", entry[32:36])
    extradata = b""
    box = entry[86:esize]
    while len(box) >= 8:
        n, k = struct.unpack(">I4s", box[:8])
        if k == b"esds":
            extradata = _esds_config(box[8:n])
        if n < 8:
            break
        box = box[n:]
    stsz = table(b"stsz")
    fixed, count = _full(stsz, "II")
    sizes = (np.full(count, fixed, np.int64) if fixed else
             np.frombuffer(stsz, ">u4", count, 12).astype(np.int64))
    stco = table(b"stco")
    if stco is not None:
        (n,) = _full(stco, "I")
        chunks = np.frombuffer(stco, ">u4", n, 8).astype(np.int64)
    else:
        co64 = table(b"co64")
        (n,) = _full(co64, "I")
        chunks = np.frombuffer(co64, ">u8", n, 8).astype(np.int64)
    stsc = table(b"stsc")
    (n,) = _full(stsc, "I")
    runs = np.frombuffer(stsc, ">u4", 3 * n, 8).reshape(n, 3).astype(
        np.int64)
    offsets = np.empty(count, np.int64)
    s = 0
    for r in range(n):
        first = runs[r, 0] - 1
        last = runs[r + 1, 0] - 1 if r + 1 < n else chunks.size
        per = runs[r, 1]
        for c in range(first, last):
            pos = chunks[c]
            for _ in range(per):
                if s >= count:
                    break
                offsets[s] = pos
                pos += sizes[s]
                s += 1
    if s != count:
        raise IOError(f"{path}: MP4 sample table holds {s} of {count} "
                      f"samples")
    stss = table(b"stss")
    if stss is None:
        keys = np.ones(count, bool)
    else:
        (n,) = _full(stss, "I")
        keys = np.zeros(count, bool)
        idx = np.frombuffer(stss, ">u4", n, 8).astype(np.int64) - 1
        keys[idx[(idx >= 0) & (idx < count)]] = True
    stts = table(b"stts")
    (n,) = _full(stts, "I")
    deltas = np.frombuffer(stts, ">u4", 2 * n, 8).reshape(n, 2).astype(
        np.int64)
    fps = _mp4_rate(timescale, deltas)
    refused = None
    edts = _child(fh, *trak, b"edts")
    elst = _child(fh, *edts, b"elst") if edts else None
    if elst is not None:
        e = _body(fh, elst)
        version = e[0]
        (n,) = _full(e, "I")
        entries = [struct.unpack_from(">qqhh" if version == 1 else
                                      ">iihh", e, 8 + i * (20 if version
                                                           == 1 else 12))
                   for i in range(n)]
        if not (n == 1 and entries[0][1] == 0):
            refused = "an MP4 edit list other than one entry from the " \
                      "first sample"
    return Container(path, "mp4", codec.decode("latin-1"), width, height,
                     offsets, sizes, keys, count, fps, extradata,
                     refused=refused)


def _mp4_rate(timescale: int, deltas: np.ndarray) -> float:
    """The frame rate FFmpeg guesses for a track: the timescale over the
    sample duration, when every sample lasts as long."""
    if timescale <= 0 or deltas.size == 0:
        return 0.0
    durations = deltas[:, 1][deltas[:, 0] > 0]
    if durations.size and np.all(durations == durations[0]) \
            and durations[0] > 0:
        return timescale / float(durations[0])
    total = int((deltas[:, 0] * deltas[:, 1]).sum())
    return float(deltas[:, 0].sum()) * timescale / total if total else 0.0


# --------------------------------------------------------------------------
# AVI
# --------------------------------------------------------------------------

_AVIIF_KEYFRAME = 0x10


def _riff_chunks(fh, start: int, end: int):
    """(fourcc, body offset, size, list type or None) in [start, end)."""
    pos = start
    while pos + 8 <= end:
        fh.seek(pos)
        hdr = fh.read(12)
        if len(hdr) < 8:
            return
        kind, size = struct.unpack("<4sI", hdr[:8])
        if kind in (b"LIST", b"RIFF"):
            yield kind, pos + 12, size - 4, hdr[8:12]
        else:
            yield kind, pos + 8, size, None
        pos += 8 + size + (size & 1)


def _avi(path: str, fh) -> Container:
    fh.seek(0, 2)
    end = fh.tell()
    riffs = [(off, min(off + size, end)) for kind, off, size, sub in
             _riff_chunks(fh, 0, end) if kind == b"RIFF"
             and sub in (b"AVI ", b"AVIX")]
    first = riffs[0]
    stream = -1
    strh = strf = None
    movis = []
    idx1 = None
    stream_no = 0
    total = 0
    for kind, off, size, sub in _riff_chunks(fh, *first):
        if kind == b"LIST" and sub == b"hdrl":
            for k2, o2, s2, sub2 in _riff_chunks(fh, off, off + size):
                if k2 == b"avih":
                    fh.seek(o2)
                    total = struct.unpack("<IIIII", fh.read(20))[4]
                if k2 != b"LIST" or sub2 != b"strl":
                    continue
                sh = sf = None
                for k3, o3, s3, _ in _riff_chunks(fh, o2, o2 + s2):
                    if k3 == b"strh":
                        fh.seek(o3)
                        sh = fh.read(s3)
                    elif k3 == b"strf":
                        fh.seek(o3)
                        sf = fh.read(s3)
                if sh is not None and sh[:4] == b"vids" and stream < 0:
                    stream, strh, strf = stream_no, sh, sf
                stream_no += 1
        elif kind == b"LIST" and sub == b"movi":
            movis.append((off, off + size))
        elif kind == b"idx1":
            idx1 = (off, size)
    if stream < 0 or strf is None:
        raise IOError(f"{path}: AVI without a video stream")
    for off, stop in riffs[1:]:
        for kind, o2, s2, sub in _riff_chunks(fh, off, stop):
            if kind == b"LIST" and sub == b"movi":
                movis.append((o2, o2 + s2))
    scale, rate = struct.unpack_from("<II", strh, 20)
    (length,) = struct.unpack_from("<I", strh, 32)
    (_, width, height, _, bit_count, compression) = struct.unpack_from(
        "<IiiHHI", strf, 0)
    extradata = strf[40:]
    tag = f"{stream:02d}".encode()
    offsets, sizes, ix_keys = [], [], []
    for start, stop in movis:
        for kind, off, size, sub in _riff_chunks(fh, start, stop):
            if kind == b"LIST" and sub == b"rec ":
                inner = list(_riff_chunks(fh, off, off + size))
            else:
                inner = [(kind, off, size, sub)]
            for k, o, s, _ in inner:
                if k[:2] == tag and k[2:] in (b"dc", b"db"):
                    offsets.append(o)
                    sizes.append(s)
                elif k == b"ix" + tag:
                    ix_keys.append(_odml_keys(fh, o, s))
    n = len(offsets)
    keys = np.ones(n, bool)
    if ix_keys:
        flags = np.concatenate(ix_keys)
        if flags.size == n:
            keys = flags
    elif idx1 is not None:
        fh.seek(idx1[0])
        raw = fh.read(idx1[1])
        entries = np.frombuffer(raw, "<u4", len(raw) // 16 * 4).reshape(
            -1, 4)
        ids = [struct.pack("<I", int(v)) for v in entries[:, 0]]
        mine = np.array([i[:2] == tag and i[2:] in (b"dc", b"db")
                         for i in ids], bool).reshape(-1)
        flags = (entries[mine, 1] & _AVIIF_KEYFRAME) != 0
        if flags.size == n:
            keys = flags
    codec = (struct.pack("<I", compression).decode("latin-1")
             if compression > 3 else "raw")
    fps = rate / scale if scale else 0.0
    count = length if length else (total or n)
    return Container(path, "avi", codec, width, abs(height),
                     np.asarray(offsets, np.int64),
                     np.asarray(sizes, np.int64), keys, int(count), fps,
                     bytes(extradata), bit_count=bit_count)


def _odml_keys(fh, off: int, size: int) -> np.ndarray:
    """Key-frame flags of an OpenDML standard index chunk (``ix##``): bit
    31 of an entry's size marks a frame that is not a key frame."""
    fh.seek(off)
    raw = fh.read(size)
    per, sub, kind, n = struct.unpack_from("<HBBI", raw, 0)
    if kind != 1 or per != 2:  # AVI_INDEX_OF_CHUNKS, two dwords an entry
        return np.zeros(0, bool)
    entries = np.frombuffer(raw, "<u4", 2 * n, 24).reshape(n, 2)
    return (entries[:, 1] & 0x80000000) == 0


# --------------------------------------------------------------------------
# MP4 writing
# --------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _box(kind: bytes, *parts: bytes) -> bytes:
    body = b"".join(parts)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _desc(tag: int, body: bytes) -> bytes:
    """An MPEG-4 descriptor, its size in four bytes as FFmpeg writes it."""
    n = len(body)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + body


def mp4_timescale(res: int, inc: int) -> tuple:
    """(timescale, sample duration) of a track at `res` / `inc` frames a
    second: both doubled until the timescale reaches 10000, as FFmpeg's
    MP4 muxer scales a video track's time base (exact for any rate)."""
    while res < 10000:
        res, inc = res * 2, inc * 2
    return res, inc


class Mp4Writer:
    """A streaming MP4 muxer of one ``mp4v`` (MPEG-4 Part 2) video track,
    laid out as FFmpeg's MP4 muxer lays out cv2's files: ``ftyp``, an 8-byte
    ``free`` box, the ``mdat`` the packets are appended to, and at
    :meth:`close` the ``moov``. An ``mdat`` past 4 GiB takes the ``free``
    box's bytes for a 64-bit size; chunk offsets past 2^32 make the chunk
    table ``co64``. Each packet is a chunk of its own; only the sample
    table (size, offset and key flag of each packet) stays in memory.

    `timescale` and `delta`: the track's time units a second and a
    packet's duration in them (:func:`mp4_timescale`); `config`: the
    decoder's headers (VOS, VO and VOL), the ``esds``
    DecoderSpecificInfo."""

    def __init__(self, path, width: int, height: int, timescale: int,
                 delta: int, config: bytes):
        self.path = str(path)
        self.width, self.height = int(width), int(height)
        self.timescale, self.delta = int(timescale), int(delta)
        self.config = bytes(config)
        self._sizes = array("I")
        self._offsets = array("Q")
        self._keys = array("I")  # 1-based sample numbers
        self._fh = open(self.path, "wb")
        self._fh.write(_box(b"ftyp", b"isom", struct.pack(">I", 0x200),
                            b"isomiso2mp41"))
        self._mdat = self._fh.tell()  # the free box, then the mdat's header
        self._fh.write(_box(b"free") + struct.pack(">I4s", 8, b"mdat"))
        self._pos = self._mdat + 16

    def __len__(self) -> int:
        return len(self._sizes)

    def add(self, packet: bytes, key: bool):
        """Append one frame's packet; `key`: an I-VOP."""
        if self._fh is None:
            raise ValueError(f"{self.path}: the MP4 writer is closed")
        self._fh.write(packet)
        self._sizes.append(len(packet))
        self._offsets.append(self._pos)
        if key:
            self._keys.append(len(self._sizes))
        self._pos += len(packet)

    def close(self):
        """Write the mdat's size and the moov; a second call does
        nothing."""
        if self._fh is None:
            return
        fh, self._fh = self._fh, None
        try:
            size = self._pos - (self._mdat + 8)
            if size > _U32:
                fh.seek(self._mdat)
                fh.write(struct.pack(">I4sQ", 1, b"mdat",
                                     self._pos - self._mdat))
            else:
                fh.seek(self._mdat + 8)
                fh.write(struct.pack(">I4s", size, b"mdat"))
            fh.seek(self._pos)
            fh.write(self.moov())
        finally:
            fh.close()

    def moov(self) -> bytes:
        """The ``moov`` box of the packets added so far."""
        n = len(self._sizes)
        duration = n * self.delta
        movie = (duration * 1000 + self.timescale // 2) // self.timescale
        v = 1 if max(duration, movie) > _U32 else 0
        times = ">QQIQ" if v else ">IIII"
        mvhd = _full_box(b"mvhd", v, 0, struct.pack(times, 0, 0, 1000, movie),
                         struct.pack(">IH10x", 0x10000, 0x100), _MATRIX,
                         bytes(24), struct.pack(">I", 2))
        tk = ">QQI4xQ" if v else ">III4xI"
        tkhd = _full_box(b"tkhd", v, 3, struct.pack(tk, 0, 0, 1, movie),
                         bytes(8), struct.pack(">HHH2x", 0, 0, 0), _MATRIX,
                         struct.pack(">II", self.width << 16,
                                     self.height << 16))
        md = ">QQIQ" if v else ">IIII"
        mdhd = _full_box(b"mdhd", v, 0, struct.pack(
            md, 0, 0, self.timescale, duration), struct.pack(">HH", 0x55C4,
                                                               0))
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide"),
                         b"VideoHandler\0")
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                       _full_box(b"url ", 0, 1)))
        total = sum(self._sizes)
        seconds = duration / self.timescale if duration else 1.0
        rate = int(total * 8 / seconds)
        # MPEG-4 Visual (0x20), a visual stream; the largest packet, the
        # mean bit rate as both rates
        buffer = min(max(self._sizes, default=0), 0xFFFFFF)
        dcd = _desc(0x04, bytes([0x20, 0x11]) + buffer.to_bytes(3, "big")
                    + struct.pack(">II", rate, rate)
                    + _desc(0x05, self.config))
        esds = _full_box(b"esds", 0, 0, _desc(0x03, struct.pack(">HB", 1, 0)
                                             + dcd + _desc(0x06, b"\x02")))
        entry = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                     struct.pack(">HHIII", self.width, self.height,
                                 0x480000, 0x480000, 0),
                     struct.pack(">H", 1), bytes(32),
                     struct.pack(">Hh", 0x18, -1), esds)
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry)
        stts = _full_box(b"stts", 0, 0, struct.pack(">I", 1 if n else 0),
                         struct.pack(">II", n, self.delta) if n else b"")
        stss = _full_box(b"stss", 0, 0, struct.pack(">I", len(self._keys)),
                         _be(self._keys, "I"))
        stsc = _full_box(b"stsc", 0, 0, struct.pack(">I", 1 if n else 0),
                         struct.pack(">III", 1, 1, 1) if n else b"")
        stsz = _full_box(b"stsz", 0, 0, struct.pack(">II", 0, n),
                         _be(self._sizes, "I"))
        wide = n and self._offsets[-1] > _U32
        stco = _full_box(b"co64" if wide else b"stco", 0, 0,
                         struct.pack(">I", n),
                         _be(self._offsets, "Q" if wide else "I"))
        stbl = _box(b"stbl", stsd, stts, stss, stsc, stsz, stco)
        minf = _box(b"minf", vmhd, dinf, stbl)
        trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
        return _box(b"moov", mvhd, trak)


def _be(values: array, kind: str) -> bytes:
    """`values` as big-endian `kind` ("I" or "Q") integers."""
    return np.asarray(values, np.uint64).astype(">u4" if kind == "I" else
                                                ">u8").tobytes()
