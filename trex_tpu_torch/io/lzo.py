"""ctypes binding for the native LZO1X codec (``native/lzo1x.cpp``).

The .pv container LZO-compresses frame payloads (reference
pv.cpp:713-774); this module provides `compress`/`decompress` over the
port's copy of the C++ implementation of the public LZO1X bitstream,
which is one source of the host library that ``ops/labeling.py``
builds.
"""
from __future__ import annotations

import ctypes

from ..ops.labeling import _lib


class LZOError(RuntimeError):
    pass


_ERRORS = {
    -1: "input overrun", -2: "output overrun",
    -3: "lookbehind underrun", -4: "stream corrupt", -5: "bad arguments",
}


def compress(data: bytes) -> bytes:
    lib = _lib()
    cap = lib.trex_lzo1x_worst_case(len(data))
    out = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(0)
    rc = lib.trex_lzo1x_compress(data, len(data), out, cap, ctypes.byref(out_len))
    if rc != 0:
        raise LZOError(f"lzo1x compress failed: {_ERRORS.get(rc, rc)}")
    return out.raw[: out_len.value]


def decompress(data: bytes, uncompressed_size: int) -> bytes:
    lib = _lib()
    out = ctypes.create_string_buffer(uncompressed_size or 1)
    out_len = ctypes.c_size_t(0)
    rc = lib.trex_lzo1x_decompress(
        data, len(data), out, uncompressed_size, ctypes.byref(out_len)
    )
    if rc != 0:
        raise LZOError(f"lzo1x decompress failed: {_ERRORS.get(rc, rc)}")
    if out_len.value != uncompressed_size:
        raise LZOError(
            f"lzo1x decompress size mismatch: got {out_len.value}, "
            f"expected {uncompressed_size}"
        )
    return out.raw[: out_len.value]
