"""The .pv container — bit-compatible reader/writer.

Implements the PV format of the reference (byte-level layout documented in
reference Application/src/ProcessedVideo/pv.cpp:1053-1099 / Header::write,
docs/formats.rst "PreprocessedVideo (pv)" section):

HEADER:
    (string)  "PV<version+1>"           strings are u32-length-prefixed
    (string)  encoding name             (>= V_14; before: u8 channels [+ u8 enum idx >= V_12])
    (i32,i32) resolution width,height   (cv::Size)
    (4x u16)  crop offsets left,top,right,bottom
    (i64)     conversion range start or -1      (>= V_15)
    (i64)     conversion range end or -1        (>= V_15)
    (string)  source path                       (>= V_15)
    (u8)      line_size (sizeof ShortHorizontalLine == 4)
    (u32)     num_frames      [patched on close]
    (u64)     index_offset    [patched on close]
    (u64)     timestamp µs since epoch
    (string)  project name
    (bytes)   average image w*h*channels
    (u64)     mask size (0 = none) [+ mask bytes]

DATA (per frame):
    (u8) compression flag
    if 1: (u32) compressed size, (u32) uncompressed size, lzo1x bytes
    payload:
        (u64) timestamp µs relative to header timestamp
        (u16) n objects
        (i32) source frame index or -1          (>= V_9)
        per object:
            (u16) start_y, (u8) flags [>=V_8], (u16) n mask lines,
            lines (4 B each: u16 x0, u16 (x1<<1|eol)), pixel bytes
        (u16) n predictions [+ prediction blobs] (>= V_9/V_10)

TRAILER: u64(0) sentinel, index table (u64 per frame), metadata string;
then num_frames/index_offset/timestamp patched in the header.

Compression rule (pv.cpp:713-774): compress when encoding==rgb8 or payload
>= 15000 B, keep only if compressed + 8 < original.
"""
from __future__ import annotations

import json
import struct
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Optional

import numpy as np

from . import lzo

CURRENT_VERSION = 15  # file magic "PV15" == enum V_15

ENCODING_ORDER = ["gray", "r3g3b2", "rgb8", "binary"]  # u8 enum order (<V_14)

STORAGE_CHANNELS = {"gray": 1, "r3g3b2": 1, "rgb8": 3, "binary": 0}

COMPRESSION_THRESHOLD = 15000


def storage_channels(encoding: str) -> int:
    return STORAGE_CHANNELS[encoding]


def average_channels(encoding: str) -> int:
    return 1 if encoding == "binary" else STORAGE_CHANNELS[encoding]


# ----------------------------------------------------------------------
# mask line codec: array[K,3] of (y, x0, x1 inclusive)  <->  packed bytes
# ----------------------------------------------------------------------

def pack_lines(lines: np.ndarray) -> bytes:
    """Pack (K,3) [y,x0,x1] int array into ShortHorizontalLine bytes.

    Layout per line (4 B): u16 x0, u16 ((x1 << 1) | eol) where eol marks
    the last line of the current y; following lines are on y+1. Rows must
    be sorted by y; consecutive y values must increase by exactly 1 when
    eol fires (holes are not representable — the reference splits such
    blobs before writing).
    """
    if len(lines) == 0:
        return b""
    lines = np.asarray(lines, dtype=np.int64)
    y = lines[:, 0]
    if np.any(np.diff(y) < 0):
        raise ValueError("mask lines must be sorted by y")
    dy = np.diff(y)
    if np.any(dy > 1):
        raise ValueError("mask lines must not skip y rows (split the blob)")
    eol = np.empty(len(lines), dtype=bool)
    eol[:-1] = dy == 1
    eol[-1] = True
    packed = np.empty((len(lines), 2), dtype="<u2")
    packed[:, 0] = lines[:, 1]
    packed[:, 1] = (lines[:, 2].astype(np.uint32) << 1) | eol
    return packed.tobytes()


def unpack_lines(data: bytes, start_y: int, legacy: bool = False) -> np.ndarray:
    """Unpack ShortHorizontalLine bytes into (K,3) [y,x0,x1] int32 array.

    Legacy (<V_7) and current layouts share the same bit packing
    (x0:u16; x1 in the upper 15 bits of the second u16, eol in bit 0).
    """
    if not data:
        return np.zeros((0, 3), dtype=np.int32)
    raw = np.frombuffer(data, dtype="<u2").reshape(-1, 2)
    x0 = raw[:, 0].astype(np.int32)
    x1 = (raw[:, 1] >> 1).astype(np.int32)
    eol = (raw[:, 1] & 1).astype(np.int32)
    y = start_y + np.concatenate([[0], np.cumsum(eol[:-1])]).astype(np.int32)
    return np.stack([y, x0, x1], axis=1)


def lines_num_pixels(lines: np.ndarray) -> int:
    if len(lines) == 0:
        return 0
    lines = np.asarray(lines)
    return int(np.sum(lines[:, 2] - lines[:, 1] + 1))


# ----------------------------------------------------------------------
# low-level IO helpers (little-endian, strings u32-length-prefixed)
# ----------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError(f"pv: truncated read at {self.pos} (+{n})")
        self.pos += n
        return b

    def u8(self):
        return self.read(1)[0]

    def u16(self):
        return struct.unpack("<H", self.read(2))[0]

    def i32(self):
        return struct.unpack("<i", self.read(4))[0]

    def u32(self):
        return struct.unpack("<I", self.read(4))[0]

    def i64(self):
        return struct.unpack("<q", self.read(8))[0]

    def u64(self):
        return struct.unpack("<Q", self.read(8))[0]

    def string(self) -> str:
        n = self.u32()
        return self.read(n).decode("utf-8", errors="replace")


# ----------------------------------------------------------------------
# header / frame
# ----------------------------------------------------------------------

@dataclass
class PVHeader:
    encoding: str = "gray"
    width: int = 0
    height: int = 0
    offsets: tuple = (0, 0, 0, 0)  # left, top, right, bottom
    conversion_start: Optional[int] = None
    conversion_end: Optional[int] = None
    source: str = ""
    num_frames: int = 0
    index_offset: int = 0
    timestamp: int = 0  # µs since epoch
    name: str = ""
    average: Optional[np.ndarray] = None  # (h, w, c) or (h, w) uint8
    mask: Optional[np.ndarray] = None
    metadata: Optional[str] = None
    version: int = CURRENT_VERSION
    line_size: int = 4
    index_table: list = field(default_factory=list)
    average_tdelta: float = 0.0

    @property
    def resolution(self):
        return (self.width, self.height)

    def metadata_dict(self) -> dict:
        if not self.metadata:
            return {}
        try:
            raw = json.loads(self.metadata)
        except json.JSONDecodeError:
            return {}
        out = {}
        from ..config.metaparse import parse_value

        for k, v in raw.items():
            out[k] = parse_value(v) if isinstance(v, str) else v
        return out


@dataclass
class PVFrame:
    timestamp: int = 0  # µs relative to header timestamp
    source_index: int = -1
    index: int = -1
    # per object
    masks: list = field(default_factory=list)  # list of (K,3) [y,x0,x1]
    pixels: list = field(default_factory=list)  # list of bytes / np.uint8 arrays
    flags: list = field(default_factory=list)  # list of u8
    predictions: list = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.masks)

    def add_object(self, lines: np.ndarray, pixels=None, flags: int = 0):
        lines = np.asarray(lines, dtype=np.int32)
        if len(lines) == 0:
            return  # reference drops empty objects (pv.cpp Frame::add_object)
        self.masks.append(lines)
        self.pixels.append(
            np.asarray(pixels, dtype=np.uint8) if pixels is not None else None
        )
        self.flags.append(flags)


# object flag bits (pv::Blob::Flags, from usage in the reference
# BackgroundSubtraction.cpp:218-222 / pv.cpp read_from)
FLAG_SPLIT = 0x1
FLAG_IS_TAG = 0x2
FLAG_IS_INSTANCE_SEGMENTATION = 0x4
FLAG_IS_RGB = 0x8
FLAG_IS_R3G3B2 = 0x10
FLAG_IS_BINARY = 0x20


def _encoding_flags(encoding: str) -> int:
    f = 0
    if encoding == "rgb8":
        f |= FLAG_IS_RGB
    elif encoding == "r3g3b2":
        f |= FLAG_IS_R3G3B2
    elif encoding == "binary":
        f |= FLAG_IS_BINARY
    return f


def _pack_all_lines(masks: list) -> tuple[bytes, np.ndarray, np.ndarray]:
    """Vectorized pack_lines over every blob of a frame at once.

    Returns (packed bytes for ALL rows, per-blob row counts, per-blob
    num_pixels). Byte range of blob i: [4*starts[i], 4*ends[i]).
    Semantically identical to per-blob pack_lines (same validation)."""
    n = len(masks)
    counts = np.fromiter((len(m) for m in masks), np.int64, n)
    total = int(counts.sum())
    if total == 0:
        return b"", counts, np.zeros(n, np.int64)
    alll = np.concatenate(
        [np.asarray(m, np.int64).reshape(-1, 3) for m in masks if len(m)])
    ends = np.cumsum(counts)
    starts = ends - counts
    y = alll[:, 0]
    dy = np.diff(y)
    # intra-blob transitions only: row i -> i+1 where i+1 is not a start
    intra = np.ones(total - 1, bool) if total > 1 else np.zeros(0, bool)
    inner_starts = starts[(starts > 0) & (starts < total)]
    intra[inner_starts - 1] = False
    if np.any((dy < 0) & intra):
        raise ValueError("mask lines must be sorted by y")
    if np.any((dy > 1) & intra):
        raise ValueError("mask lines must not skip y rows (split the blob)")
    eol = np.empty(total, bool)
    eol[:-1] = (dy == 1) & intra
    eol[ends - 1] = True
    packed = np.empty((total, 2), dtype="<u2")
    packed[:, 0] = alll[:, 1]
    packed[:, 1] = (alll[:, 2].astype(np.uint32) << 1) | eol
    widths = alll[:, 2] - alll[:, 1] + 1
    cw = np.concatenate([[0], np.cumsum(widths)])
    npix = cw[ends] - cw[starts]
    return packed.tobytes(), counts, npix


def serialize_frame(frame: PVFrame, encoding: str) -> tuple[bytes, bool]:
    """Serialize one frame payload; returns (payload, compressed_flag)."""
    channels = storage_channels(encoding)
    parts = [struct.pack("<QHi", frame.timestamp, frame.n,
                         frame.source_index if frame.source_index >= 0 else -1)]
    enc_flags = _encoding_flags(encoding)
    all_packed, counts, npix = _pack_all_lines(frame.masks[:frame.n])
    offs = np.concatenate([[0], np.cumsum(counts)]) * 4
    for i in range(frame.n):
        lines = frame.masks[i]
        packed = all_packed[offs[i]:offs[i + 1]]
        start_y = int(lines[0, 0]) if len(lines) else 0
        parts.append(struct.pack("<HBH", start_y,
                                 (frame.flags[i] | enc_flags) & 0xFF,
                                 len(lines)))
        parts.append(packed)
        if channels > 0 and len(lines):
            px = frame.pixels[i]
            expect = int(npix[i]) * channels
            if px is None or px.size != expect:
                raise ValueError(
                    f"object {i}: expected {expect} pixel bytes, got "
                    f"{0 if px is None else px.size}"
                )
            parts.append(px.tobytes())
    n_pred = len(frame.predictions)
    parts.append(struct.pack("<H", n_pred))
    if n_pred:
        from .predictions import pack_prediction

        if n_pred != frame.n:
            raise ValueError("predictions must cover all objects or none")
        for p in frame.predictions:
            parts.append(pack_prediction(p))
    payload = b"".join(parts)

    if encoding == "rgb8" or len(payload) >= COMPRESSION_THRESHOLD:
        comp = lzo.compress(payload)
        if len(comp) + 8 < len(payload):
            return (
                struct.pack("<II", len(comp), len(payload)) + comp,
                True,
            )
    return payload, False


def _maybe_correct_illegal_lines(lines, px, channels: int):
    """correct_illegal_lines (grabber doc): blobs written by old
    software versions can carry OVERLAPPING lines on one row. When
    the setting is on, rows are sorted and each line's x0 is clamped
    past its predecessor's x1, with the pixel array re-sliced to
    match. Default off: the common case pays nothing."""
    from ..config import global_settings

    try:
        if not global_settings()["correct_illegal_lines"]:
            return lines, px
    except Exception:  # noqa: BLE001 - no registry in exotic embeds
        return lines, px
    if len(lines) < 2:
        return lines, px
    order = np.lexsort((lines[:, 1], lines[:, 0]))
    ls = lines[order]
    illegal = (ls[1:, 0] == ls[:-1, 0]) & (ls[1:, 1] <= ls[:-1, 2])
    if not illegal.any():
        return lines, px
    out_lines = []
    out_px = []
    off_of = {}
    if px is not None:
        widths = lines[:, 2] - lines[:, 1] + 1
        starts = np.concatenate([[0], np.cumsum(widths)[:-1]])
        off_of = {i: int(starts[i]) for i in range(len(lines))}
    prev_y, prev_x1 = -1, -1
    for oi in order:
        y, x0, x1 = (int(v) for v in lines[oi])
        cut = 0
        if y == prev_y and x0 <= prev_x1:
            cut = prev_x1 + 1 - x0
            x0 = prev_x1 + 1
        if x0 > x1:
            continue  # fully swallowed by the previous line
        out_lines.append((y, x0, x1))
        if px is not None:
            s0 = off_of[int(oi)] + cut
            out_px.append(px[s0 * channels:
                             (s0 + x1 - x0 + 1) * channels])
        prev_y, prev_x1 = y, x1
    lines = np.asarray(out_lines, lines.dtype).reshape(-1, 3)
    if px is not None:
        px = np.concatenate(out_px) if out_px \
            else px[:0]
    return lines, px


def parse_frame(data: bytes, version: int, encoding: str,
                line_size: int = 4) -> PVFrame:
    """Parse one (already decompressed) frame payload."""
    r = _Reader(data)
    f = PVFrame()
    if version < 4:  # V_1..V_3 enum values 0..2 => file magic < "PV4"
        f.timestamp = r.u32()
    else:
        f.timestamp = r.u64()
    n = r.u16()
    if version >= 9:
        f.source_index = r.i32()
    channels = storage_channels(encoding)
    for _ in range(n):
        start_y = r.u16()
        flags = r.u8() if version >= 8 else 0
        mask_n = r.u16()
        lines = unpack_lines(r.read(mask_n * line_size), start_y,
                             legacy=version < 7)
        npx = lines_num_pixels(lines)
        px = None
        if channels > 0:
            px = np.frombuffer(r.read(npx * channels), dtype=np.uint8)
        lines, px = _maybe_correct_illegal_lines(lines, px, channels)
        f.masks.append(lines)
        f.pixels.append(px)
        f.flags.append(flags)
    if version >= 9 and r.pos < len(data):
        n_pred = r.u16()
        if n_pred > 0:
            from .predictions import unpack_prediction

            # the stored count governs the loop (normally == n objects;
            # trusting n instead mis-reads short/corrupt trailers)
            for _ in range(n_pred):
                pred, r.pos = unpack_prediction(data, r.pos, version)
                f.predictions.append(pred)
    return f


# ----------------------------------------------------------------------
# File
# ----------------------------------------------------------------------

class PVFile:
    """Read/write access to a .pv file.

    Usage:
        with PVFile.create(path, header) as f: f.add_frame(frame)
        with PVFile.open(path) as f: frame = f.read_frame(3)
    """

    def __init__(self, path, mode: str, header: PVHeader, fh: BinaryIO):
        self.path = Path(path)
        self.mode = mode
        self.header = header
        self._fh = fh
        self._patch = {}
        self._prev_time: Optional[int] = None
        self._running_tdelta = 0

    # ---------------- writing ----------------
    @classmethod
    def create(cls, path, header: PVHeader) -> "PVFile":
        if header.width <= 0 or header.height <= 0:
            raise ValueError("resolution of the video has not been set")
        fh = open(path, "wb")
        self = cls(path, "w", header, fh)
        self._write_header()
        return self

    def _w(self, fmt: str, *vals):
        self._fh.write(struct.pack(fmt, *vals))

    def _wstring(self, s: str):
        b = s.encode("utf-8")
        self._w("<I", len(b))
        self._fh.write(b)

    def _write_header(self):
        h = self.header
        fh = self._fh
        h.version = CURRENT_VERSION
        self._wstring(f"PV{CURRENT_VERSION}")
        self._wstring(h.encoding)
        self._w("<ii", h.width, h.height)
        self._w("<4H", *[int(x) for x in h.offsets])
        self._w("<q", h.conversion_start if h.conversion_start is not None else -1)
        self._w("<q", h.conversion_end if h.conversion_end is not None else -1)
        self._wstring(h.source or "")
        self._w("<B", h.line_size)
        self._patch["num_frames"] = fh.tell()
        self._w("<I", 0)
        self._patch["index_offset"] = fh.tell()
        self._w("<Q", 0)
        if not h.timestamp:
            h.timestamp = int(time.time() * 1e6)
        self._patch["timestamp"] = fh.tell()
        self._w("<Q", h.timestamp)
        self._wstring(h.name or Path(self.path).stem)
        ch = average_channels(h.encoding)
        if h.average is not None:
            avg = np.asarray(h.average, dtype=np.uint8)
            if avg.ndim == 2:
                avg = avg[:, :, None]
            if avg.shape[:2] != (h.height, h.width) or avg.shape[2] != ch:
                raise ValueError(
                    f"average image shape {avg.shape} does not match "
                    f"{h.height}x{h.width}x{ch}"
                )
            fh.write(avg.tobytes())
        else:
            fh.write(bytes(h.width * h.height * ch))
        if h.mask is not None:
            m = np.asarray(h.mask, dtype=np.uint8)
            self._w("<Q", m.size)
            fh.write(m.tobytes())
        else:
            self._w("<Q", 0)

    def add_frame(self, frame: PVFrame):
        if self.mode != "w":
            raise IOError("file not open for writing")
        h = self.header
        if not h.index_table and h.conversion_start is not None \
                and frame.source_index != h.conversion_start:
            raise ValueError(
                f"first frame source index {frame.source_index} does not "
                f"match conversion range start {h.conversion_start}"
            )
        if self._prev_time is not None and frame.timestamp <= self._prev_time:
            raise ValueError(
                f"non-monotonic frame timestamp {frame.timestamp} <= "
                f"{self._prev_time}"
            )
        if self._prev_time is not None:
            self._running_tdelta += frame.timestamp - self._prev_time
        self._prev_time = frame.timestamp

        payload, compressed = serialize_frame(frame, h.encoding)
        offset = self._fh.tell()
        self._fh.write(b"\x01" if compressed else b"\x00")
        self._fh.write(payload)
        h.index_table.append(offset)
        h.num_frames += 1
        h.average_tdelta = (
            self._running_tdelta / h.num_frames if h.num_frames else 0
        )

    def set_metadata(self, values: dict):
        """Store settings metadata (map of name -> meta-format string)."""
        from ..config.metaparse import format_value

        self.header.metadata = json.dumps(
            {k: v if isinstance(v, str) else format_value(v)
             for k, v in values.items()}
        )

    def _finalize_write(self):
        h = self.header
        fh = self._fh
        self._w("<Q", 0)  # sentinel before index table (pv.cpp stop_writing)
        h.index_offset = fh.tell()
        for idx in h.index_table:
            self._w("<Q", idx)
        self._wstring(h.metadata if h.metadata is not None else "{}")
        end = fh.tell()
        fh.seek(self._patch["num_frames"])
        self._w("<I", h.num_frames)
        fh.seek(self._patch["index_offset"])
        self._w("<Q", h.index_offset)
        fh.seek(self._patch["timestamp"])
        self._w("<Q", h.timestamp)
        fh.seek(end)
        fh.truncate()

    # ---------------- modify (append / rewind) ----------------
    @classmethod
    def open_modify(cls, path) -> "PVFile":
        """Open an existing .pv for continued writing (pv::FileMode::
        MODIFY, reference pv.cpp; behavior pinned by the reference's
        PVTest.JumpAroundInFile/DoItInOne): the writer resumes after
        the last frame; `reset_to_frame` rewinds first."""
        existing = cls.open(path)
        h = existing.header
        data = existing._data
        existing._fh.close()
        if h.version != CURRENT_VERSION:
            raise ValueError(
                f"can only modify V_{CURRENT_VERSION} files "
                f"(got V_{h.version})")
        fh = open(path, "r+b")
        self = cls(path, "w", h, fh)
        # recover the header patch offsets by replaying the layout
        r = _Reader(data)
        r.string()          # magic
        r.string()          # encoding (V_14+)
        r.read(8)           # width,height
        r.read(8)           # offsets
        r.read(16)          # conversion range
        r.string()          # source
        r.read(1)           # line size
        self._patch["num_frames"] = r.pos
        r.u32()
        self._patch["index_offset"] = r.pos
        r.u64()
        self._patch["timestamp"] = r.pos
        # writing resumes at the sentinel before the index table
        fh.seek(h.index_offset - 8)
        if h.index_table:
            self._prev_time = self._frame_timestamp_at(h.index_table[-1])
            first_ts = self._frame_timestamp_at(h.index_table[0])
            self._running_tdelta = self._prev_time - first_ts
        return self

    def _frame_timestamp_at(self, offset: int) -> int:
        """Parse just the timestamp of the frame starting at `offset`."""
        self._fh.flush()
        pos = self._fh.tell()
        self._fh.seek(offset)
        compressed = self._fh.read(1) == b"\x01"
        if compressed:
            comp_len, uncomp_len = struct.unpack("<II", self._fh.read(8))
            payload = lzo.decompress(self._fh.read(comp_len),
                                     uncomp_len)
        else:
            payload = self._fh.read(16)
        ts = struct.unpack("<Q", payload[:8])[0]
        self._fh.seek(pos)
        return ts

    def reset_to_frame(self, n: int):
        """Drop every frame from index `n` on; the next add_frame
        overwrites from there (pv::File::reset_to_frame)."""
        if self.mode != "w":
            raise IOError("file not open for writing")
        h = self.header
        n = int(n)
        if n < 0 or n > h.num_frames:
            raise ValueError(f"cannot reset to frame {n} "
                             f"of {h.num_frames}")
        if n == h.num_frames:
            return
        resume = h.index_table[n]  # start byte of the dropped frame
        h.index_table = h.index_table[:n]
        h.num_frames = n
        if n:
            self._prev_time = self._frame_timestamp_at(h.index_table[-1])
            first_ts = self._frame_timestamp_at(h.index_table[0])
            self._running_tdelta = self._prev_time - first_ts
        else:
            self._prev_time = None
            self._running_tdelta = 0
        h.average_tdelta = (self._running_tdelta / h.num_frames
                            if h.num_frames else 0)
        self._fh.seek(resume)

    # ---------------- reading ----------------
    @classmethod
    def open(cls, path) -> "PVFile":
        fh = open(path, "rb")
        data = fh.read()
        r = _Reader(data)
        h = PVHeader()
        magic = r.string()
        if not magic.startswith("PV"):
            raise ValueError(f"{path}: not a PV file (magic {magic!r})")
        # The file magic stores enum+1; we keep h.version as that magic
        # number, i.e. "PV15" -> version 15 == reference enum V_15.
        h.version = int(magic[2:])
        if h.version > CURRENT_VERSION:
            raise ValueError(f"unknown pv version {h.version}")
        v = h.version
        if v >= 14:
            h.encoding = r.string()
        else:
            channels = r.u8()
            if v >= 12:
                idx = r.u8()
                h.encoding = ENCODING_ORDER[idx]
            else:
                h.encoding = "gray" if channels == 1 else "rgb8"
        h.width = r.i32()
        h.height = r.i32()
        if v >= 3:
            h.offsets = struct.unpack("<4H", r.read(8))
        if v >= 15:
            start, end = r.i64(), r.i64()
            h.conversion_start = start if start >= 0 else None
            h.conversion_end = end if end >= 0 else None
            h.source = r.string()
        h.line_size = r.u8()
        if h.line_size != 4:
            raise ValueError(f"unsupported line size {h.line_size}")
        h.num_frames = r.u32()
        h.index_offset = r.u64()
        h.timestamp = r.u64()
        h.name = r.string()
        ch = average_channels(h.encoding)
        avg = np.frombuffer(r.read(h.width * h.height * ch), dtype=np.uint8)
        h.average = avg.reshape(h.height, h.width, ch)
        if v >= 2:
            mask_size = r.u64()
            if mask_size:
                m = np.frombuffer(r.read(mask_size), dtype=np.uint8)
                h.mask = m.reshape(h.height, h.width)
                mx = h.mask.max()
                if mx > 1:
                    h.mask = h.mask // mx
        # index table
        it = np.frombuffer(
            data[h.index_offset : h.index_offset + 8 * h.num_frames], dtype="<u8"
        )
        h.index_table = it.tolist()
        if v >= 5:
            mr = _Reader(data, h.index_offset + 8 * h.num_frames)
            try:
                h.metadata = mr.string()
            except (EOFError, struct.error):
                h.metadata = None
        self = cls(path, "r", h, fh)
        self._data = data
        return self

    def __len__(self):
        return self.header.num_frames

    def read_frame(self, index: int) -> PVFrame:
        if self.mode != "r":
            raise IOError("file not open for reading")
        h = self.header
        if not 0 <= index < h.num_frames:
            raise IndexError(index)
        r = _Reader(self._data, h.index_table[index])
        if h.version >= 6:
            flag = r.u8()
            if flag:
                comp_size = r.u32()
                uncomp_size = r.u32()
                payload = lzo.decompress(r.read(comp_size), uncomp_size)
            else:
                payload = self._data[r.pos :]
        else:
            payload = self._data[r.pos :]
        f = parse_frame(payload, h.version, h.encoding, h.line_size)
        f.index = index
        return f

    def __iter__(self):
        for i in range(self.header.num_frames):
            yield self.read_frame(i)

    # ---------------- shared ----------------
    def close(self):
        if self._fh is None:
            return
        if self.mode == "w":
            self._finalize_write()
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def fix_file(path, output=None) -> tuple:
    """Repair a .pv file by dropping unreadable frames and rebuilding the
    index table (pv::File::fix_file, reference pv.h:553-555).

    Returns (n_kept, n_dropped). Writes to `output` (default: in place
    via a temp file)."""
    import tempfile

    path = Path(path)
    src = PVFile.open(path)
    h = src.header
    new_header = PVHeader(
        encoding=h.encoding, width=h.width, height=h.height,
        offsets=h.offsets, conversion_start=h.conversion_start,
        conversion_end=h.conversion_end, source=h.source,
        timestamp=h.timestamp, name=h.name,
        average=h.average, mask=h.mask, metadata=h.metadata)
    out_path = Path(output) if output else None
    tmp = None
    if out_path is None:
        tmp = tempfile.NamedTemporaryFile(
            dir=path.parent, suffix=".pv.tmp", delete=False)
        tmp.close()
        out_path = Path(tmp.name)
    kept = dropped = 0
    last_ts = -1
    with PVFile.create(out_path, new_header) as dst:
        if h.metadata is not None:
            dst.header.metadata = h.metadata
        for i in range(h.num_frames):
            try:
                fr = src.read_frame(i)
            except Exception:
                dropped += 1
                continue
            if fr.timestamp <= last_ts:
                fr.timestamp = last_ts + 1
            last_ts = fr.timestamp
            if kept == 0 and fr.source_index >= 0 \
                    and fr.source_index != dst.header.conversion_start:
                # the original first frame was dropped: re-anchor the
                # conversion range so add_frame accepts the survivor
                dst.header.conversion_start = fr.source_index
            dst.add_frame(fr)
            kept += 1
    src.close()
    if tmp is not None:
        out_path.replace(path)
    return kept, dropped


def merge_files(output, inputs: list) -> int:
    """Merge several .pv files into one (pvinfo_merge role): frames are
    concatenated in time order; all inputs must share resolution and
    encoding. Returns the number of frames written."""
    sources = [PVFile.open(p) for p in inputs]
    h0 = sources[0].header
    for s in sources[1:]:
        if (s.header.width, s.header.height) != (h0.width, h0.height):
            raise ValueError("merge requires equal resolutions")
        if s.header.encoding != h0.encoding:
            raise ValueError("merge requires equal encodings")
    header = PVHeader(encoding=h0.encoding, width=h0.width,
                      height=h0.height, average=h0.average,
                      name=Path(str(output)).stem,
                      timestamp=min(s.header.timestamp for s in sources))
    n = 0
    with PVFile.create(output, header) as dst:
        dst.header.metadata = h0.metadata
        offset_ts = 0
        for s in sources:
            last = None
            for i in range(s.header.num_frames):
                fr = s.read_frame(i)
                fr.timestamp += offset_ts
                fr.source_index = n
                dst.add_frame(fr)
                last = fr.timestamp
                n += 1
            if last is not None:  # empty inputs keep the offset
                offset_ts = last + 1
    for s in sources:
        s.close()
    return n
