"""Reference-binary `.results` files (read + write).

Byte-level format recovered from the reference's Output::ResultsFormat
(tracking/Output.cpp — header: :1233-1350, individual block: :505-983
and :1058-1230, file body: :1437-1492 and :1640-1720; version enum
Output.h:87-132). Current version V_39 writes "TRACK38" (enum value).

Everything is little-endian. Strings are u32-length-prefixed (same
DataFormat convention as the .pv container). `data_long_t` is int64.
Vec2/Size2 are two float32. Each individual block is LZO1X-compressed
and prefixed with u64 compressed / u64 uncompressed sizes
(Output.cpp:1012-1045 read, :1185-1215 write).

This module reads ALL versions >= V_18 (zip-compressed individuals,
2019+) and writes V_39.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..io.lzo import compress as lzo_compress
from ..io.lzo import decompress as lzo_decompress

# Versions enum values (Output.h:87-132; V_1 == 0)
V_2, V_3, V_4, V_5, V_7, V_8, V_9, V_10 = 1, 2, 3, 4, 6, 7, 8, 9
V_13, V_14, V_15, V_17, V_18, V_19, V_20 = 12, 13, 14, 16, 17, 18, 19
V_22, V_23, V_24, V_25, V_26, V_27, V_28 = 21, 22, 23, 24, 25, 26, 27
V_29, V_30, V_31, V_32, V_33, V_34, V_35 = 28, 29, 30, 31, 32, 33, 34
V_36, V_37, V_38, V_39 = 35, 36, 37, 38
CURRENT = V_39


class _Reader:
    def __init__(self, data: bytes):
        self.b = data
        self.o = 0

    def raw(self, n: int) -> bytes:
        d = self.b[self.o:self.o + n]
        if len(d) != n:
            raise EOFError("unexpected end of .results data")
        self.o += n
        return d

    def skip(self, n: int):
        self.o += n

    def u8(self):
        return self.raw(1)[0]

    def u16(self):
        return struct.unpack("<H", self.raw(2))[0]

    def u32(self):
        return struct.unpack("<I", self.raw(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.raw(8))[0]

    def i32(self):
        return struct.unpack("<i", self.raw(4))[0]

    def i64(self):
        return struct.unpack("<q", self.raw(8))[0]

    def f32(self):
        return struct.unpack("<f", self.raw(4))[0]

    def f64(self):
        return struct.unpack("<d", self.raw(8))[0]

    def vec2(self):
        return struct.unpack("<ff", self.raw(8))

    def string(self) -> str:
        return self.raw(self.u32()).decode("utf-8", "replace")


class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def raw(self, b: bytes):
        self.parts.append(b)

    def u8(self, v):
        self.raw(struct.pack("<B", v))

    def u16(self, v):
        self.raw(struct.pack("<H", v))

    def u32(self, v):
        self.raw(struct.pack("<I", v))

    def u64(self, v):
        self.raw(struct.pack("<Q", v))

    def i32(self, v):
        self.raw(struct.pack("<i", v))

    def i64(self, v):
        self.raw(struct.pack("<q", v))

    def f32(self, v):
        self.raw(struct.pack("<f", v))

    def vec2(self, x, y):
        self.raw(struct.pack("<ff", x, y))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.raw(b)

    def data(self) -> bytes:
        return b"".join(self.parts)


# ---------------------------------------------------------------------------


@dataclass
class ResultsBlob:
    """pv::CompressedBlob as stored per frame (Output.cpp read_blob)."""
    lines: np.ndarray  # (K, 3) int32 [y, x0, x1]
    flags: int = 0
    parent_id: int = -1
    prediction: Optional[dict] = None  # {clid, p, pose, outlines, original}


@dataclass
class ResultsMidline:
    len: float = 0.0
    angle: float = 0.0
    offset: tuple = (0.0, 0.0)
    front: tuple = (0.0, 0.0)
    tail_index: int = -1
    head_index: int = -1
    segments: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 4), np.float32))
    # columns: height, l_length, x, y  (V20MidlineSegment, Output.h:75)


@dataclass
class ResultsOutline:
    first: tuple = (0.0, 0.0)
    points: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint16))
    scale: float = 1.0


@dataclass
class ResultsIndividual:
    id: int
    name: str = ""
    frames: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    positions: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 2), np.float32))
    angles: np.ndarray = field(default_factory=lambda: np.zeros(0, np.float32))
    blobs: list = field(default_factory=list)  # ResultsBlob per frame
    thresholded_size: dict = field(default_factory=dict)  # frame -> px
    midlines: dict = field(default_factory=dict)  # frame -> ResultsMidline
    outlines: dict = field(default_factory=dict)  # frame -> ResultsOutline
    qrcodes: dict = field(default_factory=dict)  # frame -> (id, p, samples)
    auto_matched: list = field(default_factory=list)  # frames


@dataclass
class ResultsFile:
    version: int = CURRENT
    gui_frame: int = 0
    consecutive: list = field(default_factory=list)  # (start, end)
    video_resolution: tuple = (0, 0)
    video_length: int = 0
    average: Optional[np.ndarray] = None
    analysis_range: tuple = (-1, -1)
    creation_time: int = 0
    settings: str = ""
    cmd_line: str = ""
    rec_data: dict = field(default_factory=dict)  # frame -> {bid: [float]}
    # Categorize::DataStore block (CategorizeDatastore.cpp:1312-1371):
    # {"labels": [names], "probs": {frame: {bid: label_id}},
    #  "ranged": [(start, end, label_id, [bids len == end-start+1])]}
    categorize: Optional[dict] = None
    tags: dict = field(default_factory=dict)  # id -> {frame: (bid, p)}
    auto_assign: dict = field(default_factory=dict)  # id -> [(s, e, [bids])]
    frame_properties: list = field(default_factory=list)  # (frame, ts, n)
    individuals: list = field(default_factory=list)
    active: dict = field(default_factory=dict)  # frame -> [ids]


def _unpack_lines(raw: np.ndarray, start_y: int) -> np.ndarray:
    """ShortHorizontalLine array -> (K, 3) [y, x0, x1]. Same packing as
    the .pv container V_7+: u16 x0, u16 (x1 << 1) | eol."""
    x0 = raw[0::2].astype(np.int32)
    packed = raw[1::2].astype(np.int32)
    x1 = packed >> 1
    eol = packed & 1
    y = start_y + np.concatenate([[0], np.cumsum(eol)[:-1]])
    return np.stack([y, x0, x1], axis=1).astype(np.int32)


def _pack_lines(lines: np.ndarray) -> np.ndarray:
    out = np.zeros(len(lines) * 2, np.uint16)
    out[0::2] = lines[:, 1].astype(np.uint16)
    ys = lines[:, 0]
    eol = np.ones(len(lines), np.int32)
    eol[:-1] = (ys[1:] != ys[:-1]).astype(np.int32)
    out[1::2] = ((lines[:, 2].astype(np.int32) << 1) | eol).astype(np.uint16)
    return out


def _read_prediction(r: _Reader, version: int) -> Optional[dict]:
    clid = r.u8()
    if clid == 255:
        return None
    pred = {"clid": clid, "p": r.u8(), "pose": [], "outlines": [],
            "original": None}
    for _ in range(r.u8()):
        pred["pose"].append((r.u16(), r.u16()))
    for _ in range(r.u8()):
        n = r.u16()
        pred["outlines"].append(
            np.frombuffer(r.raw(4 * n), "<i4").copy())
    if version >= V_37:
        m = r.u32()
        if m > 0:
            pred["original"] = np.frombuffer(r.raw(4 * m), "<i4").copy()
    return pred


def _write_prediction(w: _Writer, pred: Optional[dict],
                      version: int = CURRENT):
    if pred is None:
        w.u8(255)
        return
    w.u8(pred["clid"])
    w.u8(pred["p"])
    w.u8(len(pred["pose"]))
    for x, y in pred["pose"]:
        w.u16(x)
        w.u16(y)
    w.u8(len(pred["outlines"]))
    for o in pred["outlines"]:
        w.u16(len(o))
        w.raw(np.asarray(o, "<i4").tobytes())
    if version >= V_37:
        orig = pred.get("original")
        if orig is None or len(orig) == 0:
            w.u32(0)
        else:
            w.u32(len(orig))
            w.raw(np.asarray(orig, "<i4").tobytes())


def _read_blob(r: _Reader, version: int) -> ResultsBlob:
    if V_4 <= version <= 10:  # V_11 == 10
        r.u16()  # legacy per-blob id
    byte = r.u8() if version >= V_20 else 0
    parent = -1
    if version >= V_26:
        if byte & 0x2:
            parent = r.i64()
    elif (byte & 0x1) and V_22 <= version <= 24:
        parent = r.i64()
    start_y = r.u16()
    n = r.u16()
    if version < V_32:
        # LegacyShortHorizontalLine: u16 x0, u15 x1 + eol bit in x0?
        # (pv.h:17-35) — same byte width, compatible unpack
        raw = np.frombuffer(r.raw(4 * n), "<u2").copy()
    else:
        raw = np.frombuffer(r.raw(4 * n), "<u2").copy()
    lines = _unpack_lines(raw, start_y) if n else np.zeros((0, 3), np.int32)
    pred = _read_prediction(r, version) if version >= V_36 else None
    return ResultsBlob(lines=lines, flags=byte, parent_id=parent,
                       prediction=pred)


def _write_blob(w: _Writer, blob: ResultsBlob, version: int = CURRENT):
    if version >= V_20:
        # the parent-id presence bit moved: 0x2 since V_26, 0x1 in
        # V_22..V_25's first revisions (reader gate V_22 <= v <= 24)
        parent_bit = 0x2 if version >= V_26 else 0x1
        byte = blob.flags & ~parent_bit
        has_parent = blob.parent_id >= 0 and (
            version >= V_26 or V_22 <= version <= 24)
        if has_parent:
            byte |= parent_bit
        w.u8(byte)
        if has_parent:
            w.i64(blob.parent_id)
    lines = np.asarray(blob.lines, np.int32)
    w.u16(int(lines[0, 0]) if len(lines) else 0)
    w.u16(len(lines))
    w.raw(_pack_lines(lines).astype("<u2").tobytes())
    if version >= V_36:
        _write_prediction(w, blob.prediction, version)


def _read_midline(r: _Reader, version: int) -> ResultsMidline:
    m = ResultsMidline()
    m.len = r.f32()
    m.angle = r.f32()
    m.offset = r.vec2()
    m.front = r.vec2()
    if version >= V_24:
        m.tail_index = r.i64()
        m.head_index = r.i64()
    n = r.u64()
    if version >= V_10:
        m.segments = np.frombuffer(r.raw(16 * n), "<f4").reshape(n, 4).copy()
    else:
        seg = np.frombuffer(r.raw(12 * n), "<f4").reshape(n, 3)
        m.segments = np.column_stack(
            [seg[:, 0], seg[:, 0] * 0.5, seg[:, 1], seg[:, 2]]
        ).astype(np.float32)
    return m


def _write_midline(w: _Writer, m: ResultsMidline, version: int = CURRENT):
    w.f32(m.len)
    w.f32(m.angle)
    w.vec2(*m.offset)
    w.vec2(*m.front)
    if version >= V_24:
        w.i64(m.tail_index)
        w.i64(m.head_index)
    w.u64(len(m.segments))
    w.raw(np.asarray(m.segments, "<f4").tobytes())


def _read_outline(r: _Reader, version: int) -> ResultsOutline:
    o = ResultsOutline()
    n = r.u64()
    if V_9 < version < V_24:
        r.i64()  # tail index moved to midline at V_24
    if version >= V_17:
        o.first = (r.f32(), r.f32())
        o.points = np.frombuffer(r.raw(2 * n), "<u2").copy()
        o.scale = r.f32() if version >= V_38 else 0.1
    else:
        pts = np.frombuffer(r.raw(8 * n), "<f4").reshape(n, 2)
        o.first = tuple(pts[0]) if n else (0.0, 0.0)
        o.points = np.zeros(0, np.uint16)
        o.scale = 1.0
    return o


def _write_outline(w: _Writer, o: ResultsOutline, version: int = CURRENT):
    w.u64(len(o.points))
    if V_9 < version < V_24:
        w.i64(0)  # tail index lived here before moving to the midline
    w.f32(o.first[0])
    w.f32(o.first[1])
    w.raw(np.asarray(o.points, "<u2").tobytes())
    if version >= V_38:
        w.f32(o.scale)


def _read_individual(data: bytes, version: int) -> ResultsIndividual:
    r = _Reader(data)
    fid = r.u32() if version >= V_5 else r.u16()
    ind = ResultsIndividual(id=fid)
    if version <= V_15:
        r.skip(16)  # pixel_samples / average (pre-V_16)
    if version <= 12:  # V_13
        r.skip(3)  # identity colors
    if version >= V_7:
        ind.name = r.string()
    if version >= V_15:
        for _ in range(r.u64()):
            r.i64()  # manually matched (not used by reader)
    n = r.u64()
    frames = np.zeros(n, np.int64)
    pos = np.zeros((n, 2), np.float32)
    ang = np.zeros(n, np.float32)
    for i in range(n):
        frames[i] = r.i64()
        pos[i] = r.vec2()
        ang[i] = r.f32()
        if version < V_27:
            r.f64() if version >= V_8 else r.f32()  # stored time
        if version < V_7:
            r.u32()  # legacy blob index
        ind.blobs.append(_read_blob(r, version))
        if V_7 <= version < V_29:
            r.vec2()  # legacy weighted centroid
    ind.frames, ind.positions, ind.angles = frames, pos, ang
    if version >= V_19:
        for _ in range(r.u64()):
            f = r.i64()
            ind.thresholded_size[f] = r.u64()
    if version <= 23:  # <= V_24: interleaved posture records
        for _ in range(r.u64()):
            f = r.i64()
            r.vec2()
            r.f32()
            if version < V_27:
                r.f64() if version >= V_8 else r.f32()
            ind.midlines[f] = _read_midline(r, version)
            ind.outlines[f] = _read_outline(r, version)
    else:  # V_25+: midlines then outlines
        for _ in range(r.u64()):
            f = r.i64()
            ind.midlines[f] = _read_midline(r, version)
        for _ in range(r.u64()):
            f = r.i64()
            ind.outlines[f] = _read_outline(r, version)
    if version >= V_34:
        for _ in range(r.u64()):
            f = r.i64()
            ind.qrcodes[f] = (r.i32(), r.f32(), r.u32())
    if version >= V_39:
        for _ in range(r.u64()):
            ind.auto_matched.append(r.u32())
    return ind


def _write_individual(res: ResultsIndividual,
                      version: int = CURRENT) -> bytes:
    w = _Writer()
    w.u32(res.id)
    w.string(res.name or f"fish{res.id}")
    w.u64(0)  # manually matched (the reference writes 0, Output.cpp:1092)
    n = len(res.frames)
    w.u64(n)
    for i in range(n):
        w.i64(int(res.frames[i]))
        w.vec2(float(res.positions[i][0]), float(res.positions[i][1]))
        w.f32(float(res.angles[i]))
        if version < V_27:
            w.raw(np.float64(0.0).tobytes())  # stored frame time
        _write_blob(w, res.blobs[i], version)
        if version < V_29:
            w.vec2(0.0, 0.0)  # legacy weighted centroid
    if version >= V_19:
        w.u64(n)
        for i in range(n):
            f = int(res.frames[i])
            w.i64(f)
            w.u64(int(res.thresholded_size.get(f, 0)))
    if version <= 23:  # <= V_24: interleaved posture records
        frames = sorted(set(res.midlines) & set(res.outlines))
        w.u64(len(frames))
        for f in frames:
            w.i64(f)
            w.vec2(0.0, 0.0)
            w.f32(0.0)
            if version < V_27:
                w.raw(np.float64(0.0).tobytes())
            _write_midline(w, res.midlines[f], version)
            _write_outline(w, res.outlines[f], version)
    else:  # V_25+: midlines then outlines
        w.u64(len(res.midlines))
        for f in sorted(res.midlines):
            w.i64(f)
            _write_midline(w, res.midlines[f], version)
        w.u64(len(res.outlines))
        for f in sorted(res.outlines):
            w.i64(f)
            _write_outline(w, res.outlines[f], version)
    if version >= V_34:
        w.u64(len(res.qrcodes))
        for f in sorted(res.qrcodes):
            tid, p, samples = res.qrcodes[f]
            w.i64(f)
            w.i32(tid)
            w.f32(p)
            w.u32(samples)
    if version >= V_39:
        w.u64(len(res.auto_matched))
        for f in res.auto_matched:
            w.u32(f)
    return w.data()


# ---------------------------------------------------------------------------


def read_results(path) -> ResultsFile:
    """Read a reference-written .results file (V_18 ... V_39)."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    out = ResultsFile()
    vstr = r.string()
    if not vstr.startswith("TRACK"):
        raise ValueError(f"{path}: not a tracking results file")
    out.version = version = int(vstr[5:]) if len(vstr) > 5 else 0
    if version >= V_3:
        out.gui_frame = r.u64()
    if 10 <= version < V_15:
        r.skip(8)  # currentID (V_11..V_14)
    if version >= V_28:
        for _ in range(r.u32()):
            out.consecutive.append((r.u32(), r.u32()))
        w_, h_ = r.vec2()
        out.video_resolution = (int(w_), int(h_))
        out.video_length = r.u64()
        h, w = int(out.video_resolution[1]), int(out.video_resolution[0])
        out.average = np.frombuffer(r.raw(h * w), np.uint8).reshape(h, w).copy()
    if version >= V_30:
        out.analysis_range = (r.i64(), r.i64())
    if version >= V_34:
        out.creation_time = r.u64()
    if version >= V_14:
        out.settings = r.string()
    if version >= V_23:
        out.cmd_line = r.string()
    if version >= V_13:
        for _ in range(r.u64()):
            frame = r.i64()
            per = {}
            for _ in range(r.u64()):
                bid = r.u32()
                vs = r.u64()
                per[bid] = np.frombuffer(r.raw(4 * vs), "<f4").copy()
            out.rec_data[frame] = per
    if version >= V_33:
        if r.u8() == 1:  # Categorize::DataStore block
            labels = []
            for _ in range(r.u64()):
                r.i32()  # label id == list position
                labels.append(r.string())
            probs = {}
            for _ in range(r.u64()):
                frame = r.u32()
                per = {}
                for _ in range(r.u32()):
                    bid = r.u32()
                    per[bid] = r.i32()
                if per:
                    probs[frame] = per
            ranged = []
            for _ in range(r.u64()):
                s, e = r.u32(), r.u32()
                lbl = r.i32()
                bids = np.frombuffer(r.raw(4 * (e - s + 1)),
                                     "<u4").tolist()
                ranged.append((s, e, lbl, bids))
            out.categorize = {"labels": labels, "probs": probs,
                              "ranged": ranged}
    if version >= V_35:
        for _ in range(r.u32()):
            tid = r.u32()
            dets = {}
            for _ in range(r.u32()):
                f = r.u32()
                dets[f] = (r.u32(), r.f32())
            out.tags[tid] = dets
    if version >= V_39:
        for _ in range(r.u64()):
            fid = r.u32()
            ranges = []
            for _ in range(r.u64()):
                s, e = r.u32(), r.u32()
                bids = [r.u32() for _ in range(r.u64())]
                ranges.append((s, e, bids))
            out.auto_assign[fid] = ranges
    # frame properties
    for _ in range(r.u64()):
        frame = r.i64()
        ts = r.u64()
        active = r.i64() if version >= 30 else -1  # V_31
        out.frame_properties.append((frame, ts, active))
    # individuals
    n_ind = r.u64()
    for _ in range(n_ind):
        if version >= V_18:
            size = r.u64()
            uncompressed = r.u64()
            block = lzo_decompress(r.raw(size), uncompressed)
            out.individuals.append(_read_individual(block, version))
        else:
            raise ValueError(
                f"results version V_{version + 1} (< V_18) not supported")
    # active individuals per frame
    for _ in range(r.u64()):
        frame = r.i64()
        out.active[frame] = [r.i64() for _ in range(r.u64())]
    return out


def write_results(path, res: ResultsFile, version: int = CURRENT):
    """Write a .results file the reference application can load.

    `version` selects the on-disk layout (V_18 .. V_39 — older
    layouts predate the LZO-per-individual framing and are read-only
    in the reference too); every gate mirrors read_results /
    Output.cpp's version changelog (Output.h:95-144). Features the
    chosen version cannot carry (e.g. tags before V_35) are dropped,
    exactly like a reference binary of that era."""
    if not V_18 <= version <= CURRENT:
        raise ValueError(f"unsupported .results version {version}")
    w = _Writer()
    w.string(f"TRACK{version}")
    w.u64(res.gui_frame)
    if version >= V_28:
        w.u32(len(res.consecutive))
        for s, e in res.consecutive:
            w.u32(s)
            w.u32(e)
        w.vec2(float(res.video_resolution[0]),
               float(res.video_resolution[1]))
        w.u64(res.video_length)
        avg = res.average
        if avg is None:
            avg = np.zeros((int(res.video_resolution[1]),
                            int(res.video_resolution[0])), np.uint8)
        w.raw(np.ascontiguousarray(avg, np.uint8).tobytes())
    if version >= V_30:
        w.i64(res.analysis_range[0])
        w.i64(res.analysis_range[1])
    if version >= V_34:
        w.u64(res.creation_time)
    w.string(res.settings)
    if version >= V_23:
        w.string(res.cmd_line)
    w.u64(len(res.rec_data))
    for frame, per in res.rec_data.items():
        w.i64(frame)
        w.u64(len(per))
        for bid, vec in per.items():
            w.u32(bid)
            w.u64(len(vec))
            w.raw(np.asarray(vec, "<f4").tobytes())
    if version >= V_33:
        if res.categorize:
            c = res.categorize
            w.u8(1)
            w.u64(len(c["labels"]))
            for i, name in enumerate(c["labels"]):
                w.i32(i)
                w.string(name)
            w.u64(len(c["probs"]))
            for frame, per in c["probs"].items():
                w.u32(frame)
                w.u32(len(per))
                for bid, lbl in per.items():
                    w.u32(bid)
                    w.i32(lbl)
            w.u64(len(c["ranged"]))
            for s_, e_, lbl, bids in c["ranged"]:
                w.u32(s_)
                w.u32(e_)
                w.i32(lbl)
                w.raw(np.asarray(bids, "<u4").tobytes())
        else:
            w.u8(0)  # no categorize data
    if version >= V_35:
        w.u32(len(res.tags))
        for tid, dets in res.tags.items():
            w.u32(tid)
            w.u32(len(dets))
            for f, (bid, p) in dets.items():
                w.u32(f)
                w.u32(bid)
                w.f32(p)
    if version >= V_39:
        w.u64(len(res.auto_assign))
        for fid, ranges in res.auto_assign.items():
            w.u32(fid)
            w.u64(len(ranges))
            for s, e, bids in ranges:
                w.u32(s)
                w.u32(e)
                w.u64(len(bids))
                for b in bids:
                    w.u32(b)
    w.u64(len(res.frame_properties))
    for frame, ts, active in res.frame_properties:
        w.i64(frame)
        w.u64(ts)
        if version >= 30:  # V_31
            w.i64(active)
    w.u64(len(res.individuals))
    for ind in res.individuals:
        block = _write_individual(ind, version)
        comp = lzo_compress(block)
        w.u64(len(comp))
        w.u64(len(block))
        w.raw(comp)
    w.u64(len(res.active))
    for frame in sorted(res.active):
        w.i64(frame)
        ids = res.active[frame]
        w.u64(len(ids))
        for i in ids:
            w.i64(i)
    blob = w.data()
    with open(path, "wb") as f:
        f.write(blob)
