"""Writes the video fixtures of the port's decoder tests and of
chip_smoke.py's phase 19 with cv2 5.0.0's ``VideoWriter`` (FFmpeg's
``mpeg4``, ``mjpeg`` and ``rawvideo`` encoders), the MPEG-4 streams its
writer cannot ask for (four motion vectors, video packets, adaptive
quantisation) with the libavcodec cv2 bundles, called through ctypes, the
AVI files cv2 does not write (those streams', an OpenDML file) by hand,
and ``digests.json``:
the sha256 of each file's frames as ``cv2.VideoCapture`` reads them. The
machine with the card has no OpenCV, so these files travel with the
repository. Run from the repository's root: ``python
tests/data/video_decode/write_fixtures.py``. The same seed writes the same
files."""
import ctypes
import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[2]
FPS = 25
SCENE_FRAMES = 16  # chip_smoke.WO_FRAMES
# cv2.VideoCapture's reads after the sequential pass: index order of the
# seeks (backward and forward, across key frames)
SEEKS = (29, 3, 15, 0, 16, 13, 27, 12, 2)


def ellipses(h, w, n, seed, black=True):
    """Colour ellipses moving fast, past the frame's edges, on a black (or
    blue) background with a little noise."""
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (12, 3))
    out = []
    for t in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        if not black:
            img[:] = (160, 90, 40)
        for k in range(12):
            cx = int((k * 53 + t * 7 * (1 + k % 3)) % (w + 60)) - 30
            cy = int((k * 31 + t * 5 * (1 + k % 2)) % (h + 60)) - 30
            cv2.ellipse(img, (cx, cy), (14, 8), t * 9 + k * 30, 0, 360,
                        tuple(int(c) for c in colours[k]), -1)
        out.append(cv2.add(img, rng.integers(0, 3, img.shape,
                                             dtype=np.uint8)))
    return out


def texture_pan(h, w, n, seed, speed):
    """A sharp texture panned fast in a wobbling direction (half-pel
    vectors, large levels, escape codes)."""
    rng = np.random.default_rng(seed)
    big = rng.integers(0, 256, (h + 400, w + 400, 3), dtype=np.uint8)
    big = cv2.GaussianBlur(big, (0, 0), 1.2)
    big[::7] = 0
    big[:, ::11] = 255
    out = []
    for t in range(n):
        x = int(np.clip(200 + speed * t * np.cos(t / 5), 0, 400))
        y = int(np.clip(200 + speed * t * np.sin(t / 7), 0, 400))
        out.append(np.ascontiguousarray(big[y:y + h, x:x + w]))
    return out


def zero_rich(h, w, n, seed):
    """A field of 0 and 3 with sparse bright points drifting by half
    pixels: no-rounding averages over zeros."""
    rng = np.random.default_rng(seed)
    big = (rng.random((h * 4, w * 3)) < 0.5).astype(np.uint8) * 3
    big = np.where(rng.random(big.shape) < 0.1,
                   rng.integers(0, 256, big.shape), big).astype(np.uint8)
    out = []
    for t in range(n):
        y0, x0 = 100 + (t * 7) // 2, 100 + t // 3
        g = big[y0:y0 + h, x0:x0 + w]
        out.append(np.ascontiguousarray(cv2.merge([g, g, g])))
    return out


def write(name, fourcc, frames):
    h, w = frames[0].shape[:2]
    code = cv2.VideoWriter_fourcc(*fourcc) if fourcc else 0
    vw = cv2.VideoWriter(str(HERE / name), code, FPS, (w, h))
    assert vw.isOpened(), name
    for f in frames:
        vw.write(f)
    vw.release()


def riff(kind, body):
    return kind + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def lst(kind, body):
    return riff(b"LIST", kind + body)


def avi_headers(w, h, n, handler, compression, bits, size, extra=b""):
    avih = struct.pack("<IIIIIIIIII4I", 1000000 // FPS, 0, 0, 0x10, n, 0, 1,
                       size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", handler, 0, 0, 0, 0,
                       1, FPS, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, compression, size,
                       0, 0, 0, 0)
    return lst(b"hdrl", riff(b"avih", avih) + lst(
        b"strl", riff(b"strh", strh) + riff(b"strf", strf) + extra))


def odml_avi(name, packets, w, h, handler, keys):
    """An OpenDML AVI of `packets`: the first half in the RIFF AVI, the
    rest in a RIFF AVIX, each movi with an ix00 standard index, a super
    index in the stream header, no idx1."""
    half = len(packets) // 2
    parts = [packets[:half], packets[half:]]
    # the super index's size is fixed first: 2 entries
    sup_len = 24 + 2 * 16
    head = avi_headers(w, h, len(packets), handler, struct.unpack(
        "<I", handler)[0], 24, w * h * 3,
        extra=riff(b"indx", b"\0" * sup_len))
    head_len = len(head)
    riffs, entries = [], []
    offset = 12 + head_len + 8  # file offset of the first movi list's body
    for p, part in enumerate(parts):
        movi_body = b""
        locs = []
        for pk in part:
            locs.append(offset + 4 + len(movi_body) + 8)
            movi_body += riff(b"00dc", pk)
        ix = struct.pack("<HBBI4sQI", 2, 0, 1, len(part), b"00dc",
                         offset + 4, 0)
        first = half * p
        for i, (loc, pk) in enumerate(zip(locs, part)):
            ix += struct.pack("<II", loc - (offset + 4),
                              len(pk) | (0 if keys[first + i]
                                         else 0x80000000))
        ix_chunk = riff(b"ix00", ix)
        entries.append((offset + 4 + len(movi_body), len(ix_chunk),
                        len(part)))
        movi = lst(b"movi", movi_body + ix_chunk)
        riffs.append(movi)
        # the next RIFF's movi list starts 12 bytes into it
        offset += len(movi) + 12
    sup = struct.pack("<HBBI4sIII", 4, 0, 0, 2, b"00dc", 0, 0, 0)
    for off, size, dur in entries:
        sup += struct.pack("<QII", off, size, dur)
    head = head.replace(riff(b"indx", b"\0" * sup_len), riff(b"indx", sup))
    data = riff(b"RIFF", b"AVI " + head + riffs[0])
    data += riff(b"RIFF", b"AVIX" + riffs[1])
    (HERE / name).write_bytes(data)


def lavc_mpeg4(frames, options):
    """MPEG-4 Part 2 packets of BGR `frames` from the libavcodec (62.28)
    that cv2 5.0.0 bundles, with its AVOptions `options`: what cv2's
    VideoWriter cannot ask for. AVFrame and AVPacket are read at their
    libavutil 60 / libavcodec 62 offsets."""
    libs = Path(cv2.__file__).parents[1] / "opencv_python.libs"
    util = ctypes.CDLL(str(next(libs.glob("libavutil-*"))),
                       mode=ctypes.RTLD_GLOBAL)
    lav = ctypes.CDLL(str(next(libs.glob("libavcodec-*"))),
                      mode=ctypes.RTLD_GLOBAL)
    vp = ctypes.c_void_p
    lav.avcodec_find_encoder_by_name.restype = vp
    lav.avcodec_alloc_context3.restype = vp
    lav.avcodec_alloc_context3.argtypes = [vp]
    lav.avcodec_open2.argtypes = [vp, vp, vp]
    lav.av_packet_alloc.restype = vp
    lav.avcodec_send_frame.argtypes = [vp, vp]
    lav.avcodec_receive_packet.argtypes = [vp, vp]
    lav.av_packet_unref.argtypes = [vp]
    util.av_opt_set.argtypes = [vp, ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int]
    util.av_frame_alloc.restype = vp
    util.av_frame_get_buffer.argtypes = [vp, ctypes.c_int]
    util.av_frame_make_writable.argtypes = [vp]
    h, w = frames[0].shape[:2]
    codec = lav.avcodec_find_encoder_by_name(b"mpeg4")
    ctx = lav.avcodec_alloc_context3(codec)
    for k, v in dict(video_size=f"{w}x{h}", pixel_format="yuv420p",
                     time_base=f"1/{FPS}", **options).items():
        assert util.av_opt_set(ctx, k.encode(), str(v).encode(), 1) == 0, k
    assert lav.avcodec_open2(ctx, codec, None) == 0
    frame = util.av_frame_alloc()
    ints = ctypes.cast(frame, ctypes.POINTER(ctypes.c_int32))
    ints[26], ints[27], ints[29] = w, h, 0  # width, height, yuv420p
    assert util.av_frame_get_buffer(frame, 0) == 0
    data = ctypes.cast(frame, ctypes.POINTER(vp))
    pkt = lav.av_packet_alloc()
    out = []

    def drain():
        while lav.avcodec_receive_packet(ctx, pkt) == 0:
            ptr = ctypes.cast(pkt + 24, ctypes.POINTER(vp))[0]
            size = ctypes.cast(pkt + 32, ctypes.POINTER(ctypes.c_int32))[0]
            out.append(ctypes.string_at(ptr, size))
            lav.av_packet_unref(pkt)

    cw, ch = w // 2, h // 2
    for f in frames:
        a = cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420).ravel()
        planes = (a[:w * h].reshape(h, w),
                  a[w * h:w * h + cw * ch].reshape(ch, cw),
                  a[w * h + cw * ch:].reshape(ch, cw))
        assert util.av_frame_make_writable(frame) == 0
        for p, plane in enumerate(planes):
            stride = ints[16 + p]
            for r, row in enumerate(plane):
                ctypes.memmove(data[p] + r * stride, row.ctypes.data,
                               row.size)
        assert lav.avcodec_send_frame(ctx, frame) == 0
        drain()
    lav.avcodec_send_frame(ctx, None)
    drain()
    return out


def packets_avi(name, packets, w, h, handler):
    """An AVI of `packets` with an idx1 index (I-VOPs key frames)."""
    chunks, index = b"", b""
    for pk in packets:
        at = pk.find(b"\x00\x00\x01\xb6")
        key = at >= 0 and pk[at + 4] >> 6 == 0
        index += struct.pack("<4sIII", b"00dc", 0x10 if key else 0,
                             4 + len(chunks), len(pk))
        chunks += riff(b"00dc", pk)
    body = (b"AVI " + avi_headers(w, h, len(packets), handler, struct.unpack(
        "<I", handler)[0], 24, w * h * 3) + lst(b"movi", chunks)
        + riff(b"idx1", index))
    (HERE / name).write_bytes(riff(b"RIFF", body))


def packets(path):
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_FORMAT, -1])
    out = []
    while True:
        ok, p = cap.read()
        if not ok:
            return out
        out.append(bytes(p.ravel()))


def digest(frames):
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()


def cv2_digests(path):
    """sha256 of the frames cv2 reads, BGR and grey, in order and at
    SEEKS."""
    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    seeks = [i for i in SEEKS if i < len(frames)]
    seen = []
    for i in seeks:
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, f = cap.read()
        assert ok, (path, i)
        seen.append(f)
    grey = [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames]
    return dict(frames=n, read=len(frames), fps=cap.get(cv2.CAP_PROP_FPS),
                shape=list(frames[0].shape), bgr=digest(frames),
                grey=digest(grey), seeks=seeks, seek_bgr=digest(seen),
                seek_grey=digest(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
                                 for f in seen))


def main():
    write("ellipses_90x70.mp4", "mp4v", ellipses(70, 90, 30, 1))
    write("ellipses_90x70.avi", "XVID", ellipses(70, 90, 30, 2, False))
    write("pan_112x80.mov", "mp4v", texture_pan(80, 112, 30, 3, 14))
    write("zeros_96x80.mp4", "mp4v", zero_rich(80, 96, 30, 4))
    write("mjpg_90x70.avi", "MJPG", ellipses(70, 90, 12, 5, False))
    write("iyuv_90x70.avi", "IYUV", ellipses(70, 90, 5, 6, False))
    write("raw_90x70.avi", None, ellipses(70, 90, 4, 7))
    # four motion vectors with video packets (a resync marker every 300
    # bytes), then with adaptive quantisation (per-macroblock dquant) too
    for name, frames, options in (
            ("mv4_packets_112x80.avi", texture_pan(80, 112, 30, 3, 14),
             dict(flags="+mv4", ps=300, g=12, bf=0)),
            ("mv4_aq_90x70.avi", ellipses(70, 90, 30, 1),
             dict(flags="+mv4", ps=120, g=10, bf=0, lumi_mask=0.3,
                  dark_mask=0.3, mbd=2)),
            ("mv4_zeros_96x80.avi", zero_rich(80, 96, 30, 4),
             dict(flags="+mv4", g=15, bf=0))):
        h, w = frames[0].shape[:2]
        packets_avi(name, lavc_mpeg4(frames, options), w, h, b"FMP4")
    mj = packets(HERE / "mjpg_90x70.avi")
    odml_avi("odml_90x70.avi", mj[:6], 90, 70, b"MJPG", [True] * 6)
    sys.path.insert(0, str(REPO))
    import chip_smoke

    _, scene = chip_smoke.synth_frames(SCENE_FRAMES)
    write("scene_1024.mp4", "mp4v", [cv2.merge([f, f, f]) for f in scene])
    names = sorted(p.name for p in HERE.iterdir()
                   if p.suffix in (".mp4", ".mov", ".avi"))
    digests = {name: cv2_digests(HERE / name) for name in names}
    (HERE / "digests.json").write_text(json.dumps(digests, indent=1,
                                                  sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
