"""The port's video decoding without OpenCV (trex_tpu_torch/io/containers.py,
io/video_decode.py, native/mpeg4video.cpp) against cv2 5.0.0's
``VideoCapture`` on this machine, tolerance 0: the demuxers' packets,
frame counts and rates; the MPEG-4 Part 2 decoder's Y plane; every
frame's BGR and ``cvtColor(BGR2GRAY)`` grey, read in order and after
backward and forward seeks, of each committed fixture
(tests/data/video_decode: ``mp4v`` in MP4 and MOV, ``XVID``, ``MJPG``,
``IYUV``, fourcc 0 and an OpenDML AVI, and streams of four motion
vectors, video packets and adaptive quantisation from cv2's own
libavcodec) and of files written here with other sizes and fourccs
(``DIVX``, ``DX50``, ``FMP4``, ``YV12``); the pinned digests chip_smoke.py holds the card's machine
to; each variant the port refuses, named from its headers, raising
without cv2 and going to cv2 with it; and ``trex -task convert`` of an
``mp4v`` file through the port's CLI with cv2 blocked, byte-equal to the
JAX CLI's. The port's calls run with cv2 blocked."""
import hashlib
import json
import struct
import sys
from contextlib import contextmanager
from pathlib import Path

import cv2
import numpy as np
import pytest

import trex_tpu_torch.io.video as port_video
from trex_tpu_torch.io import video_decode as vd
from trex_tpu_torch.io.containers import open_container

DATA = Path(__file__).resolve().parent / "data" / "video_decode"
DIGESTS = json.loads((DATA / "digests.json").read_text())
FIXTURES = sorted(DIGESTS)
MPEG4 = [n for n in FIXTURES if open_container(DATA / n).codec
         in vd._MPEG4]
# files of other sizes and codecs written here: (name, fourcc, w, h, n)
WRITTEN = (("w176.mp4", "mp4v", 176, 144, 26),
           ("w250.avi", "XVID", 250, 190, 14),
           ("w64.mov", "mp4v", 64, 48, 13),
           ("w130.avi", "MJPG", 130, 98, 5),
           ("w34.avi", "IYUV", 34, 26, 3),
           ("divx.avi", "DIVX", 48, 32, 14),
           ("dx50.avi", "DX50", 80, 64, 14),
           ("fmp4.avi", "FMP4", 112, 48, 14),
           ("mp4v.avi", "mp4v", 66, 50, 14),
           ("yv12.avi", "YV12", 38, 22, 3))


@contextmanager
def no_cv2():
    saved, mod = sys.modules.get("cv2"), port_video._cv2_mod
    sys.modules["cv2"] = None
    port_video._cv2_mod = None
    try:
        yield
    finally:
        sys.modules["cv2"] = saved
        port_video._cv2_mod = mod


def _scene(h, w, n, seed):
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (8, 3))
    out = []
    for t in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        img[: h // 2] = (30, 140, 200)
        for k in range(8):
            cx = int((k * 41 + t * 9 * (1 + k % 3)) % (w + 40)) - 20
            cy = int((k * 29 + t * 6 * (1 + k % 2)) % (h + 40)) - 20
            cv2.ellipse(img, (cx, cy), (w // 8 + 2, h // 10 + 2), t * 11 + k,
                        0, 360, tuple(int(c) for c in colours[k]), -1)
        out.append(cv2.add(img, rng.integers(0, 4, img.shape,
                                             dtype=np.uint8)))
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("video_decode")
    for name, fourcc, w, h, n in WRITTEN:
        vw = cv2.VideoWriter(str(root / name), cv2.VideoWriter_fourcc(
            *fourcc), 30, (w, h))
        assert vw.isOpened()
        for f in _scene(h, w, n, w):
            vw.write(f)
        vw.release()
    return root


def _all_files(written):
    return [DATA / n for n in FIXTURES] + [written / w[0] for w in WRITTEN]


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            return cap, frames
        frames.append(f)


def _digest(frames):
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("which", range(len(FIXTURES) + len(WRITTEN)))
def test_demuxer_packets_count_and_rate_equal_cv2(written, which):
    path = _all_files(written)[which]
    cap = cv2.VideoCapture(str(path), cv2.CAP_FFMPEG,
                           [cv2.CAP_PROP_FORMAT, -1])
    want = []
    while True:
        ok, p = cap.read()
        if not ok:
            break
        want.append(bytes(p.ravel()))
    with no_cv2():
        c = open_container(path)
        with open(path, "rb") as fh:
            got = [c.read(fh, i) for i in range(len(c))]
        f = vd.VideoFile(path)
    assert got == want
    assert len(f) == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    assert f.frame_rate == cap.get(cv2.CAP_PROP_FPS)
    f.close()


@pytest.mark.parametrize("name", MPEG4)
def test_mpeg4_y_plane_equals_cv2(name):
    cap = cv2.VideoCapture(str(DATA / name))
    cap.set(cv2.CAP_PROP_CONVERT_RGB, 0)
    with no_cv2():
        f = vd.VideoFile(DATA / name)
        for i in range(len(f)):
            ok, want = cap.read()
            assert ok
            f._mpeg4_packet(i)
            np.testing.assert_array_equal(f._planes[0], want,
                                          err_msg=f"frame {i}")
    f.close()


@pytest.mark.parametrize("which", range(len(FIXTURES) + len(WRITTEN)))
def test_frames_equal_cv2_in_order_and_after_seeks(written, which):
    path = _all_files(written)[which]
    cap, want = _cv2_frames(path)
    n = len(want)
    seeks = [n - 1, 1, n // 2, 0, n // 2 + 1, n - 2, 2, n - 1]
    wanted = []
    for i in seeks:
        cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, fr = cap.read()
        assert ok
        wanted.append(fr)
    with no_cv2():
        f = vd.VideoFile(path)
        got = [f.read(i, True) for i in range(n)]
        grey = [f.read(i, False) for i in range(n)]
        sought = [f.read(i, True) for i in seeks]
        sought_grey = [f.read(i, False) for i in seeks]
    for i in range(n):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"frame {i}")
        np.testing.assert_array_equal(
            grey[i], cv2.cvtColor(want[i], cv2.COLOR_BGR2GRAY),
            err_msg=f"grey frame {i}")
    for i, a, g, b in zip(seeks, sought, sought_grey, wanted):
        np.testing.assert_array_equal(a, b, err_msg=f"seek to {i}")
        np.testing.assert_array_equal(g, cv2.cvtColor(b, cv2.COLOR_BGR2GRAY),
                                      err_msg=f"grey seek to {i}")
    f.close()


def test_pinned_digests_are_cv2s():
    """digests.json, which chip_smoke.py holds the card's machine to, is
    what cv2 5.0.0 reads from the committed fixtures."""
    for name in FIXTURES:
        d = DIGESTS[name]
        cap, frames = _cv2_frames(DATA / name)
        assert d["frames"] == int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        assert d["fps"] == cap.get(cv2.CAP_PROP_FPS)
        assert d["read"] == len(frames)
        assert d["bgr"] == _digest(frames), name
        assert d["grey"] == _digest(cv2.cvtColor(f, cv2.COLOR_BGR2GRAY)
                                    for f in frames), name
        seen = []
        for i in d["seeks"]:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
            seen.append(cap.read()[1])
        assert d["seek_bgr"] == _digest(seen), name


# -- refused variants ---------------------------------------------------------

def _vol_offsets(data: bytes) -> dict:
    """Bit offsets of the VOL fields of FFmpeg's encoder's layout (object
    layer identifier and VOL control parameters present, no VBV, no fixed
    rate), after the first VOL start code in `data`."""
    at = data.index(b"\x00\x00\x01\x20") + 4
    pos = at * 8 + 1 + 8 + 1 + 4 + 3 + 4 + 1 + 2 + 1 + 1
    fields = {"shape": pos}
    pos += 2 + 1
    res = int.from_bytes(data[pos // 8:pos // 8 + 4], "big") >> (
        16 - pos % 8) & 0xFFFF
    fields["width"] = pos + 16 + 1 + 1 + 1
    pos += 16 + 1 + 1 + 1 + 13 + 1 + 13 + 1
    for name in ("interlaced", "obmc_disable", "sprite", "not_8_bit",
                 "mpeg_quant", "complexity_disable", "resync_disable",
                 "data_partitioned"):
        fields[name] = pos
        pos += 1
    fields["time_bits"] = max((res - 1).bit_length(), 1)
    return fields


def _flip(data: bytes, bit: int) -> bytes:
    b = bytearray(data)
    b[bit // 8] ^= 0x80 >> (bit % 8)
    return bytes(b)


def _set_bits(data: bytes, bit: int, n: int, value: int) -> bytes:
    b = bytearray(data)
    for k in range(n):
        i = bit + k
        on = (value >> (n - 1 - k)) & 1
        b[i // 8] = (b[i // 8] & ~(0x80 >> (i % 8))) | (on << (7 - i % 8))
    return bytes(b)


def _first_p_vop(data: bytes, c) -> int:
    """The byte offset of the first P-VOP's coding type in the file."""
    for i in np.flatnonzero(~c.keyframes):
        off = int(c.offsets[i])
        at = data.index(b"\x00\x00\x01\xb6", off) + 4
        if data[at] >> 6 == 1:
            return at
    raise AssertionError("no P-VOP")


def _vop_coded_bit(data: bytes, at: int, time_bits: int) -> int:
    bit = at * 8 + 2
    while data[bit // 8] & (0x80 >> (bit % 8)):
        bit += 1
    return bit + 1 + 1 + time_bits + 1


# a 90x70 fixture whose headers say 69 rows, of each codec: (fixture,
# its even original)
ODD_HEIGHT = {"odd_height": "ellipses_90x70.avi",
              "mjpeg_odd_height": "mjpg_90x70.avi",
              "raw_odd_height": "iyuv_90x70.avi"}


def _avi_height(data: bytes, h: int) -> bytes:
    """`data` with the AVI main header's and BITMAPINFOHEADER's height
    set to `h`."""
    b = bytearray(data)
    struct.pack_into("<I", b, data.index(b"avih") + 8 + 36, h)
    struct.pack_into("<i", b, data.index(b"strf") + 8 + 8, h)
    return bytes(b)


def _odd_height(kind) -> bytes:
    """A 90x69 AVI made from a 90x70 fixture: the MPEG-4 file with every
    VOL's height 69, the MJPEG file with every frame's SOF height 69, the
    IYUV file rebuilt from its first frame's planes with the last luma
    row cut (the chroma keeps its 35 rows)."""
    src = ODD_HEIGHT[kind]
    data = (DATA / src).read_bytes()
    if kind == "odd_height":
        for at in [a for a in range(len(data))
                   if data.startswith(b"\x00\x00\x01\x20", a)]:
            bit = _vol_offsets(data[at:])["width"] + 13 + 1 + at * 8
            data = _set_bits(data, bit, 13, 69)
        return _avi_height(data, 69)
    if kind == "mjpeg_odd_height":
        b = bytearray(data)
        at = data.find(b"\xff\xc0")
        while at >= 0:
            struct.pack_into(">H", b, at + 5, 69)
            at = data.find(b"\xff\xc0", at + 2)
        return _avi_height(bytes(b), 69)
    sys.path.insert(0, str(DATA))
    try:
        import write_fixtures as wf
    finally:
        sys.path.pop(0)
    c = open_container(DATA / src)
    with open(DATA / src, "rb") as fh:
        planes = c.read(fh, 0)
    frame = planes[:90 * 69] + planes[90 * 70:]  # Y less its last row
    index = struct.pack("<4sIII", b"00db", 0x10, 4, len(frame))
    body = (b"AVI " + wf.avi_headers(90, 69, 1, b"IYUV", struct.unpack(
        "<I", b"IYUV")[0], 12, len(frame))
        + wf.lst(b"movi", wf.riff(b"00db", frame))
        + wf.riff(b"idx1", index))
    return wf.riff(b"RIFF", body)


def _variant(kind, tmp):
    """(path, the words of the refusal) of a refused file built from a
    fixture."""
    mp4 = (DATA / "ellipses_90x70.mp4").read_bytes()
    avi = (DATA / "ellipses_90x70.avi").read_bytes()
    vol = _vol_offsets(avi)
    if kind in ("interlaced", "obmc", "mpeg_quant", "data_partitioning"):
        field = {"interlaced": "interlaced", "obmc": "obmc_disable",
                 "mpeg_quant": "mpeg_quant",
                 "data_partitioning": "data_partitioned"}[kind]
        # every VOL of the file (one before each I-VOP)
        at = 0
        out = bytearray(avi)
        while True:
            at = avi.find(b"\x00\x00\x01\x20", at)
            if at < 0:
                break
            bit = _vol_offsets(avi[at:])[field] + at * 8
            out[bit // 8] ^= 0x80 >> (bit % 8)
            at += 4
        data = bytes(out)
        words = {"interlaced": "interlaced video",
                 "obmc": "overlapped block motion compensation",
                 "mpeg_quant": "MPEG quantisation matrices",
                 "data_partitioning": "data partitioning"}[kind]
        name = f"{kind}.avi"
    elif kind in ("vol_size", "later_vol_size"):
        # the VOL's width 96 in a 90x70 AVI: in every VOL, or from the
        # second on (a size that changes mid-stream)
        vols = [at for at in range(len(avi))
                if avi.startswith(b"\x00\x00\x01\x20", at)]
        data = avi
        for at in vols[kind == "later_vol_size":]:
            bit = _vol_offsets(avi[at:])["width"] + at * 8
            data = _set_bits(data, bit, 13, 96)
        words, name = "a VOL of 96x70 in a 90x70 container", f"{kind}.avi"
    elif kind in ("b_vop", "s_vop", "not_coded"):
        c = open_container(DATA / "ellipses_90x70.avi")
        at = _first_p_vop(avi, c)
        if kind == "not_coded":
            data = _flip(avi, _vop_coded_bit(avi, at, vol["time_bits"]))
            words = "VOPs that are not coded"
        else:
            data = _set_bits(avi, at * 8, 2, 2 if kind == "b_vop" else 3)
            words = "B-VOPs" if kind == "b_vop" else "S-VOPs"
        name = f"{kind}.avi"
    elif kind in ("xvid_tag", "xvid", "divx", "old_lavc"):
        text = {"xvid_tag": b"Lavx62.28.101", "xvid": b"XviD005000000",
                "divx": b"DivX503b1234x", "old_lavc": b"Lavc00.18.009"}[kind]
        data = avi.replace(b"Lavc62.28.101", text)
        words = {"xvid_tag": "an Xvid stream (build 0)",
                 "xvid": "an Xvid stream (build 5000000)",
                 "divx": "a DivX stream (version 503)",
                 "old_lavc": "an old libavcodec stream (build 4617)"}[kind]
        name = f"{kind}.avi"
    elif kind == "h264_avi":
        data = avi.replace(b"XVID", b"H264")
        words, name = "H.264 video (H264)", "h264.avi"
    elif kind == "avc1_mp4":
        data = mp4.replace(b"mp4v", b"avc1", 1)
        words, name = "H.264 video (avc1)", "avc1.mp4"
    elif kind == "edit_list":
        at = mp4.index(b"elst") + 4 + 4 + 4 + 4
        data = mp4[:at] + struct.pack(">i", 1024) + mp4[at + 4:]
        words, name = "an MP4 edit list", "edit.mp4"
    elif kind == "container":
        data = b"\x1aE\xdf\xa3" + bytes(60)  # a Matroska/WebM header
        words, name = "a container other than MP4/MOV and AVI", "mkv.mp4"
    elif kind == "mjpeg_progressive":
        mj = (DATA / "mjpg_90x70.avi").read_bytes()
        c = open_container(DATA / "mjpg_90x70.avi")
        at = mj.index(b"\xff\xc0", int(c.offsets[0]))
        data = mj[:at] + b"\xff\xc2" + mj[at + 2:]
        words, name = "progressive MJPEG", "progressive.avi"
    elif kind == "mjpeg_422":
        mj = (DATA / "mjpg_90x70.avi").read_bytes()
        c = open_container(DATA / "mjpg_90x70.avi")
        sof = mj.index(b"\xff\xc0", int(c.offsets[0]))
        at = sof + 2 + 2 + 1 + 2 + 2 + 1 + 1  # the first component's hv
        data = mj[:at] + b"\x21" + mj[at + 1:]
        words, name = "MJPEG with sampling [(2, 1)", "422.avi"
    elif kind in ODD_HEIGHT:
        data = _odd_height(kind)
        words, name = "an odd frame height (69)", f"{kind}.avi"
    else:
        raise KeyError(kind)
    path = tmp / name
    path.write_bytes(data)
    return path, words


VARIANTS = ("interlaced", "obmc", "mpeg_quant", "data_partitioning",
            "vol_size", "later_vol_size", "b_vop", "s_vop", "not_coded", "xvid_tag", "xvid", "divx",
            "old_lavc", "h264_avi", "avc1_mp4", "edit_list", "container",
            "mjpeg_progressive", "mjpeg_422", *ODD_HEIGHT)


@pytest.mark.parametrize("kind", VARIANTS)
def test_refused_variant_is_named_and_goes_to_opencv(tmp_path, kind):
    path, words = _variant(kind, tmp_path)
    with no_cv2():
        variant = vd.refused_variant(path)
        assert variant is not None and words in variant, variant
        with pytest.raises(ValueError, match="not decoded without OpenCV"):
            vd.VideoFile(path)
        with pytest.raises(RuntimeError) as e:
            port_video.VideoSource(str(path))
    assert str(e.value) == f"OpenCV is required for video decode " \
                           f"({variant})"
    # with OpenCV present the source is cv2's capture
    purposes = []
    real = port_video._cv2

    def spy(purpose):
        purposes.append(purpose)
        return real(purpose)

    port_video._cv2 = spy
    try:
        try:
            src = port_video.VideoSource(str(path))
            assert isinstance(src._cap, port_video._Capture)
            src.close()
        except FileNotFoundError:  # a file cv2 cannot open either
            pass
    finally:
        port_video._cv2 = real
    assert purposes == [f"video decode ({variant})"]


@pytest.mark.parametrize("kind", ("vol_size", "later_vol_size"))
def test_decoder_refuses_a_picture_of_another_size(tmp_path, kind):
    """Past the header check, the decoder itself writes no picture whose
    VOL size is not the container's: an IOError, not a write past the
    frame's buffers."""
    path, _ = _variant(kind, tmp_path)
    stream = vd.probe(path)
    stream.refused = None
    f = vd.VideoFile(path, stream)
    with pytest.raises(IOError, match="another size than the container's"
                       ".*96x70, the container says 90x70"):
        for i in range(len(f)):
            f.read(i, True)
    f.close()


@pytest.mark.parametrize("kind", ODD_HEIGHT)
def test_odd_heights_are_converted_by_another_path(tmp_path, kind):
    """Why odd heights are refused: past the refusal the port decodes
    the 90x69 file's first frame as the unscaled conversion of the 90x70
    original's first 69 rows, but cv2 5.0.0 converts an odd height by
    libswscale's scaler and returns other values (PERF.md, PR 19: up to
    114 levels apart)."""
    path, _ = _variant(kind, tmp_path)
    stream = vd.probe(path)
    stream.refused = None
    f = vd.VideoFile(path, stream)
    ours = f.read(0, True)
    f.close()
    even = _cv2_frames(DATA / ODD_HEIGHT[kind])[1][0][:69]
    np.testing.assert_array_equal(ours, even)
    theirs = _cv2_frames(path)[1][0]
    assert theirs.shape == ours.shape
    assert np.abs(theirs.astype(int) - ours).max() > 8


def test_decoded_files_never_reach_opencv(written):
    """Every fixture and written file opens, reads and seeks through the
    port's VideoSource with cv2 blocked, a path array of them too."""
    files = [str(p) for p in _all_files(written)
             if p.suffix in (".mp4", ".mov")]
    with no_cv2():
        for p in _all_files(written):
            src = port_video.VideoSource(str(p), color=True)
            assert isinstance(src._cap, vd.VideoFile)
            src.get(len(src) - 1)
            src.get(0)
            src.close()
        chain = port_video.VideoSource(files)
        assert len(chain) == sum(len(vd.VideoFile(f)) for f in files)
        chain.get(len(chain) - 1)
        chain.close()
        assert port_video._cv2_mod is None


# -- the convert task ---------------------------------------------------------

def test_mp4v_converts_and_tracks_as_the_jax_cli(tmp_path, monkeypatch):
    """tests/test_torch_image_sequences.py's scene as an ``mp4v`` MP4:
    the JAX CLI reads it through cv2, the port's with cv2 blocked; the
    convert and track tasks write byte-equal files."""
    from test_engine import _synth
    from test_torch_cli import _mask_pv_timestamp, _run, _tree
    from test_torch_image_sequences import _convert_args, _track_args
    from trex_tpu.cli import trex as jax_cli
    from trex_tpu.config import reset_global_settings as jax_reset
    from trex_tpu_torch.cli import trex as port_cli
    from trex_tpu_torch.config import reset_global_settings

    _, frames = _synth(20, 8, 200, seed=2)
    src = tmp_path / "vid.mp4"
    vw = cv2.VideoWriter(str(src), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        vw.write(cv2.merge([f, f, f]))
    vw.release()
    jax_out, port_out = tmp_path / "jax", tmp_path / "port"
    assert _run(jax_cli, jax_reset, _convert_args(str(src), jax_out)) == 0
    assert _run(jax_cli, jax_reset, _track_args(jax_out)) == 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(port_video, "_cv2_mod", None)
    assert _run(port_cli, reset_global_settings,
                _convert_args(str(src), port_out)
                + ["-detect_engine", "device"], device="cpu") == 0
    assert _run(port_cli, reset_global_settings, _track_args(port_out),
                device="cpu") == 0
    want, got = _tree(jax_out), _tree(port_out)
    assert sorted(got) == sorted(want)
    assert "vid.results" in want and "vid.pv" in want
    for name in want:
        a, b = want[name], got[name]
        if name.endswith(".pv"):
            a = _mask_pv_timestamp(a, jax_out / name)
            b = _mask_pv_timestamp(b, port_out / name)
        assert a == b, name


def test_chip_smoke_holds_the_fixtures_digests():
    """chip_smoke.py's WO_VIDEO_DIGESTS is digests.json, so that the card's
    machine is held to cv2 5.0.0's reading of the committed files."""
    import chip_smoke

    assert chip_smoke.WO_VIDEO_FIXTURES == DATA
    assert chip_smoke.WO_VIDEO_SCENE in DIGESTS
    assert DIGESTS[chip_smoke.WO_VIDEO_SCENE]["frames"] == \
        chip_smoke.WO_FRAMES
    assert {k: (d["frames"], d["fps"], tuple(d["seeks"]), d["bgr"],
                d["grey"], d["seek_bgr"], d["seek_grey"])
            for k, d in DIGESTS.items()} == chip_smoke.WO_VIDEO_DIGESTS
