"""Per-object prediction records in .pv frames (blob::Prediction).

Byte-exact with the reference's serializer (ProcessedVideo/pv.cpp:20-102,
Data::read/write<blob::Prediction>):

    u8 clid, u8 p (confidence * 255)
    u8 N (= 2 * n_pose);  n_pose x (u16 x, u16 y)          # >= PV10
    u8 n_outlines; per outline: u32 M, M x i32              # >= PV11
    u32 n_original; n_original x i32 (0 when absent)        # >= PV13

(for files older than PV10 the record is clid, p plus two ignored
bytes). Outline points are the reference's packed-int32 values and are
carried through opaquely.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class Prediction:
    clid: int = 0
    p: float = 0.0  # 0..1
    pose: Optional[np.ndarray] = None  # (K, 2) uint16 keypoints
    outlines: list = field(default_factory=list)  # list of int32 arrays
    original_outline: Optional[np.ndarray] = None  # int32 array

    @property
    def valid(self) -> bool:
        return self.p > 0 or self.clid > 0


def pack_prediction(pred) -> bytes:
    if isinstance(pred, dict):
        pred = Prediction(clid=int(pred.get("clid", 0)),
                          p=float(pred.get("p", 0.0)),
                          pose=pred.get("keypoints"))
    parts = [struct.pack("<BB", pred.clid & 0xFF,
                         int(round(max(0.0, min(1.0, pred.p)) * 255)))]
    pose = pred.pose
    if pose is None or len(pose) == 0:
        parts.append(b"\x00")
    else:
        pose = np.asarray(np.round(pose), np.uint16).reshape(-1, 2)
        parts.append(struct.pack("<B", (len(pose) * 2) & 0xFF))
        parts.append(pose.astype("<u2").tobytes())
    parts.append(struct.pack("<B", len(pred.outlines) & 0xFF))
    for ol in pred.outlines:
        ol = np.asarray(ol, np.int32).ravel()
        parts.append(struct.pack("<I", len(ol)))
        parts.append(ol.astype("<i4").tobytes())
    orig = pred.original_outline
    if orig is None or len(orig) == 0:
        parts.append(struct.pack("<I", 0))
    else:
        orig = np.asarray(orig, np.int32).ravel()
        parts.append(struct.pack("<I", len(orig)))
        parts.append(orig.astype("<i4").tobytes())
    return b"".join(parts)


def unpack_prediction(data: bytes, pos: int, version: int) -> tuple:
    """`version` is the .pv file magic number (PV10 -> 10, ...)."""
    clid, p = struct.unpack_from("<BB", data, pos)
    pos += 2
    pred = Prediction(clid=clid, p=p / 255.0)
    if version < 10:
        return pred, pos + 2  # two reserved bytes in old files
    n = data[pos]
    pos += 1
    if n:
        pred.pose = np.frombuffer(data, "<u2", n,
                                  pos).reshape(n // 2, 2).copy()
        pos += n * 2
    if version >= 11:
        n_out = data[pos]
        pos += 1
        for _ in range(n_out):
            (m,) = struct.unpack_from("<I", data, pos)
            pos += 4
            pred.outlines.append(
                np.frombuffer(data, "<i4", m, pos).copy())
            pos += m * 4
    if version >= 13:
        (m,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if m:
            pred.original_outline = np.frombuffer(data, "<i4", m,
                                                  pos).copy()
            pos += m * 4
    return pred, pos
