"""The port's raw-movie recording without OpenCV (trex_tpu_torch/io/
video_encode.py, io/containers.py::Mp4Writer, native/mpeg4video.cpp's
encoder) against cv2 5.0.0 on this machine: every frame the writer
encodes decodes bit for bit alike by cv2's ``VideoCapture``, by the
port's ``VideoFile`` (in order and after seeks, BGR and grey) and as the
encoder's own reconstruction, over drawn sizes, contents, rates and
quantisers; cv2 reads the written count, rate and size; the port's
decoder refuses none of the files; the files stay within 1.5x the bytes
and 1 dB of the PSNR of cv2's own ``mp4v`` writer on the same frames;
the muxer's 64-bit boxes, key-frame table and time scale; the pinned
digests chip_smoke.py holds the card's machine to; and ``save_raw_movie``
through the port's ``Segmenter`` against the JAX package's (which
records through cv2), also with cv2 blocked."""
import hashlib
import json
import sys
from array import array
from pathlib import Path

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import trex_tpu_torch.io.video as port_video
from trex_tpu_torch.io import containers
from trex_tpu_torch.io import video_decode as vd
from trex_tpu_torch.io import video_encode as ve

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
PINNED = json.loads((DATA / "video_encode" / "digests.json").read_text())
RATES = (25, 30, 30000 / 1001, 7.5)
# what cv2 5.0.0 reports as CAP_PROP_FOURCC for an mp4v MP4, its own
# writer's included (the sample entry is mp4v)
CV2_FOURCC = cv2.VideoWriter_fourcc(*"FMP4")


def _sha(frames) -> str:
    h = hashlib.sha256()
    for f in frames:
        h.update(np.ascontiguousarray(f).tobytes())
    return h.hexdigest()


def _compare():
    """tools/raw_movie_vs_cv2.py: the inputs, cv2's writer and PSNR."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import raw_movie_vs_cv2
    finally:
        sys.path.remove(str(REPO / "tools"))
    return raw_movie_vs_cv2


def _psnr(a, b) -> float:
    return _compare().frame_psnr(a, b)


def _encode(path, frames, fps, quantiser=0):
    """Write `frames` with the port's writer; the reconstruction of each
    frame as BGR."""
    h, w = frames[0].shape[:2]
    vw = ve.VideoWriter(path, fps, (w, h), frames[0].ndim == 3,
                        _quantiser=quantiser)
    recon = []
    for f in frames:
        vw.write(f)
        recon.append(vd.yuv420_bgr(*vw.reconstruction(), 0))
    vw.release()
    return recon


def _cv2_read(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    props = (int(cap.get(cv2.CAP_PROP_FOURCC)),
             int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
             cap.get(cv2.CAP_PROP_FPS), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    return out, props


def _assert_three_equal(path, recon, fps, size):
    """cv2's decode, the port's decode in order and after seeks (BGR and
    grey) and the reconstruction, frame for frame; cv2's properties."""
    n = len(recon)
    got, props = _cv2_read(path)
    assert props == (CV2_FOURCC, n, fps) + tuple(size)
    assert len(got) == n
    for i in range(n):
        np.testing.assert_array_equal(got[i], recon[i], err_msg=f"cv2 {i}")
    assert vd.refused_variant(path) is None
    f = vd.VideoFile(path)
    assert (len(f), f.frame_rate, f._c.codec) == (n, fps, "mp4v")
    for i in range(n):
        np.testing.assert_array_equal(f.read(i, True), recon[i],
                                      err_msg=f"port {i}")
    for i in (n - 1, 0, n // 2, 1 % n, n - 2 if n > 1 else 0):
        np.testing.assert_array_equal(f.read(i, True), recon[i])
        np.testing.assert_array_equal(
            f.read(i, False), cv2.cvtColor(recon[i], cv2.COLOR_BGR2GRAY))
    f.close()


def _content(kind, h, w, n, color, seed):
    """static, noisy, panning, or objects moving faster than the search
    range (60 px a frame) over a noisy floor."""
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if color else (h, w)
    if kind == "static":
        base = cv2.GaussianBlur(rng.integers(0, 256, shape, np.uint8),
                                (0, 0), 2)
        return [base.copy() for _ in range(n)]
    if kind == "noisy":
        return [rng.integers(0, 256, shape, np.uint8) for _ in range(n)]
    if kind == "pan":
        big = cv2.GaussianBlur(rng.integers(
            0, 256, (h + 200, w + 200) + shape[2:], np.uint8), (0, 0), 1.0)
        return [np.ascontiguousarray(big[
            int(100 + 20 * np.cos(t / 3)):][:h,
            int(100 + 30 * np.sin(t / 2) + t):][:, :w]) for t in range(n)]
    pos = rng.uniform(0, [w, h], (4, 2))
    vel = rng.uniform(-60, 60, (4, 2))
    col = rng.integers(0, 256, (4, 3))
    out = []
    for t in range(n):
        img = np.full((h, w, 3), 40, np.uint8)
        for k in range(4):
            x, y = (pos[k] + vel[k] * t) % [w, h]
            cv2.circle(img, (int(x), int(y)), 6 + 3 * k,
                       tuple(int(c) for c in col[k]), -1)
        img = cv2.add(img, rng.integers(0, 6, img.shape, np.uint8))
        out.append(img if color else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    return out


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(w=st.integers(8, 80).map(lambda v: 2 * v),
       h=st.integers(8, 64).map(lambda v: 2 * v),
       kind=st.sampled_from(["static", "noisy", "pan", "fast"]),
       color=st.booleans(), fps=st.sampled_from(RATES),
       quantiser=st.sampled_from([0, 0, 2, 31, 5, 17]),
       n=st.integers(1, 27), seed=st.integers(0, 2 ** 16))
def test_written_files_decode_alike(tmp_path, w, h, kind, color, fps,
                                    quantiser, n, seed):
    """cv2's decode == the port's decode == the reconstruction, on every
    frame, across the GOP's I-VOPs, every quantiser's DC scalers and
    escapes, vectors past the picture and past the search range."""
    frames = _content(kind, h, w, n, color, seed)
    path = tmp_path / f"{kind}_{w}x{h}.mp4"
    recon = _encode(path, frames, fps, quantiser)
    _assert_three_equal(path, recon, fps, (w, h))


def test_odd_sizes_drop_the_last_column_and_row_as_cv2(tmp_path):
    """cv2's writer writes a 51x41 frame as 50x40, cutting the last
    column and row: so does the port's, and both decode alike."""
    frames = _content("pan", 41, 51, 5, True, 3)
    recon = _encode(tmp_path / "p.mp4", frames, 25)
    vw = cv2.VideoWriter(str(tmp_path / "c.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 25, (51, 41))
    for f in frames:
        vw.write(f)
    vw.release()
    theirs, props = _cv2_read(tmp_path / "c.mp4")
    assert props[3:] == (50, 40)
    _assert_three_equal(tmp_path / "p.mp4", recon, 25, (50, 40))
    crop = [f[:40, :50] for f in frames]
    assert np.mean([_psnr(a, b) for a, b in zip(recon, crop)]) >= np.mean(
        [_psnr(a, b) for a, b in zip(theirs, crop)]) - 1.0


def test_pinned_scene_digests(tmp_path):
    """chip_smoke.py's phase-10 scene (1024^2 grey, 16 frames): the
    file's sha256 and cv2's reading of it equal tests/data/video_encode's
    digests (chip_smoke.py holds the card's machine to them), and the
    three decodes agree on every frame."""
    import chip_smoke

    want = PINNED["scene_1024.mp4"]
    _, frames = chip_smoke.synth_frames(want["frames"])
    path = tmp_path / "scene_1024.mp4"
    recon = _encode(path, list(frames), want["fps"])
    assert hashlib.sha256(path.read_bytes()).hexdigest() == want["sha256"]
    assert path.stat().st_size == want["size"]
    _assert_three_equal(path, recon, want["fps"], (1024, 1024))
    assert _sha(recon) == want["bgr"]
    grey = [cv2.cvtColor(r, cv2.COLOR_BGR2GRAY) for r in recon]
    assert _sha(grey) == want["grey"]
    f = vd.VideoFile(path)
    assert _sha(f.read(i, False) for i in range(len(f))) == want["grey"]
    assert _sha(f.read(i, True) for i in want["seeks"]) == want["seek_bgr"]
    assert _sha(f.read(i, False) for i in want["seeks"]) \
        == want["seek_grey"]
    f.close()
    # grey in, grey back within the codec's error
    assert min(_psnr(g, fr) for g, fr in zip(grey, frames)) > 40


@pytest.mark.parametrize("name", ["scene", "texture_pan", "ellipses"])
def test_size_and_quality_against_cv2_writer(tmp_path, name):
    """On the same frames as cv2's mp4v writer (the JAX package's raw
    movie): at most 1.5x its bytes, at most 1 dB below its mean PSNR of
    the decode against the input."""
    compare = _compare()
    frames, fps = compare.inputs()[name], compare.FPS
    h, w = frames[0].shape[:2]
    compare.write_cv2(tmp_path / "cv2.mp4", frames, fps)
    _encode(tmp_path / "port.mp4", frames, fps)
    psnr = {}
    for k in ("cv2", "port"):
        assert _cv2_read(tmp_path / f"{k}.mp4")[1] == (
            CV2_FOURCC, len(frames), fps, w, h)
        psnr[k] = compare.psnr(tmp_path / f"{k}.mp4", frames)
    size = {k: (tmp_path / f"{k}.mp4").stat().st_size for k in psnr}
    assert size["port"] <= 1.5 * size["cv2"], size
    assert psnr["port"] >= psnr["cv2"] - 1.0, psnr


@pytest.mark.parametrize("fps", RATES + (24, 60, 12.5))
def test_rates_round_trip(tmp_path, fps):
    """The rate as a rational: cv2's CAP_PROP_FPS and the port's
    frame_rate give it back exactly; mdhd's timescale at least 10000."""
    frames = _content("static", 16, 16, 3, False, 0)
    path = tmp_path / "r.mp4"
    _encode(path, frames, fps)
    _, props = _cv2_read(path)
    assert props[1:3] == (3, fps)
    assert vd.VideoFile(path).frame_rate == fps
    res, inc = ve.rate_fraction(fps)
    assert res / inc == fps
    ts, delta = containers.mp4_timescale(res, inc)
    assert ts >= 10000 and ts * inc == res * delta


def test_rate_fraction():
    assert ve.rate_fraction(30000 / 1001) == (30000, 1001)
    assert ve.rate_fraction(7.5) == (15, 2)
    assert ve.rate_fraction(25) == (25, 1)
    assert ve.rate_fraction(24000 / 1001) == (24000, 1001)
    for bad in (0, -1, float("nan"), 1e6):
        with pytest.raises(ValueError):
            ve.rate_fraction(bad)


def test_key_frames_every_twelfth(tmp_path):
    """stss lists the I-VOPs, every twelfth frame; cv2's seeks land on
    them."""
    frames = _content("pan", 32, 48, 30, True, 5)
    path = tmp_path / "k.mp4"
    _encode(path, frames, 25)
    c = containers.open_container(path)
    assert np.flatnonzero(c.keyframes).tolist() == [0, 12, 24]
    with open(path, "rb") as fh:
        for i in range(len(c)):
            pkt = c.read(fh, i)
            vop = pkt.find(b"\x00\x00\x01\xb6")
            assert vop == 0 and (pkt[4] >> 6 == 0) == c.keyframes[i]


def test_mp4_64_bit_boxes(tmp_path, monkeypatch):
    """Past 2^32 the mdat takes a 64-bit size and the chunk offsets go
    to co64: forced here at a threshold of 100 bytes, the file reads back
    in cv2 and the port alike; and offsets past 2^32 come back from
    co64."""
    monkeypatch.setattr(containers, "_U32", 100)
    frames = _content("pan", 32, 48, 14, False, 6)
    path = tmp_path / "wide.mp4"
    recon = _encode(path, frames, 25)
    data = path.read_bytes()
    assert data[28:36] == b"\x00\x00\x00\x01mdat" and b"co64" in data
    _assert_three_equal(path, recon, 25, (48, 32))
    monkeypatch.setattr(containers, "_U32", 0xFFFFFFFF)
    w = containers.Mp4Writer(tmp_path / "m.mp4", 16, 16, 12800, 512, b"")
    for k in range(3):
        w.add(bytes(10 + k), k == 0)
    w._offsets[1:] = array("Q", [2 ** 32 + 7, 2 ** 33])
    moov = w.moov()
    w.close()
    assert b"co64" in moov and b"stco" not in moov
    at = moov.index(b"co64") + 12  # past the version, flags and count
    assert np.frombuffer(moov, ">u8", 3, at).tolist() == [
        w._offsets[0], 2 ** 32 + 7, 2 ** 33]


def test_writer_errors(tmp_path):
    vw = ve.VideoWriter(tmp_path / "e.mp4", 25, (32, 16), True)
    with pytest.raises(ValueError):
        vw.write(np.zeros((16, 32), np.uint8))  # grey to a colour writer
    with pytest.raises(ValueError):
        vw.write(np.zeros((16, 34, 3), np.uint8))
    with pytest.raises(ValueError):
        vw.write(np.zeros((16, 32, 3), np.float32))
    vw.write(np.zeros((16, 32, 3), np.uint8))
    vw.release()
    vw.release()
    with pytest.raises(ValueError):
        vw.write(np.zeros((16, 32, 3), np.uint8))
    assert _cv2_read(tmp_path / "e.mp4")[1][1] == 1
    for size, fps in (((1, 16), 25), ((16, 16), 0)):
        with pytest.raises(ValueError):
            ve.VideoWriter(tmp_path / "x.mp4", fps, size, False)


SEG = dict(track_max_individuals=3, track_threshold=20,
           track_threshold_is_absolute=False, detect_threshold=15,
           detect_threshold_is_absolute=False, track_size_filter=[[5, 400]],
           calculate_posture=False, frame_rate=25, cm_per_pixel=1.0,
           averaging_method="max", meta_encoding="gray",
           track_background_subtraction=True, save_raw_movie=True)


def _scene_pngs(tmp_path, n=16):
    rng = np.random.default_rng(19)
    frames = []
    for f in range(n):
        img = np.full((96, 128), 200, np.int16) + rng.integers(-3, 4,
                                                               (96, 128))
        for i in range(3):
            img[20 + 20 * i:26 + 20 * i, 10 + 30 * i + 2 * f:
                20 + 30 * i + 2 * f] = 80
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    src = tmp_path / "frames"
    src.mkdir()
    for i, fr in enumerate(frames):
        cv2.imwrite(str(src / f"f_{i:03d}.png"), fr)
    return frames, str(src / "f_%03d.png")


def _payload(pv_cls, path):
    with pv_cls.open(path) as pv:
        return [[(np.asarray(m).tobytes(), np.asarray(p).tobytes())
                 for m, p in zip(fr.masks, fr.pixels)]
                for fr in (pv.read_frame(i) for i in range(len(pv)))]


def test_segmenter_raw_movie_twin(tmp_path):
    """save_raw_movie through the JAX package's Segmenter (cv2's writer)
    and the port's (its own): equal .pv payloads; both raw movies beside
    the .pv read by cv2 with the same fourcc, count, rate and size; the
    port's within 1.5x the bytes and 1 dB of the PSNR of the JAX
    package's."""
    from trex_tpu.config import reset_global_settings as jax_reset
    from trex_tpu.io.pv import PVFile as JaxPVFile
    from trex_tpu.pipeline import Segmenter as JaxSegmenter
    from trex_tpu_torch import pipeline
    from trex_tpu_torch.config import reset_global_settings
    from trex_tpu_torch.io.pv import PVFile

    frames, pattern = _scene_pngs(tmp_path)
    js = jax_reset()
    ps = reset_global_settings()
    for k, v in SEG.items():
        js.set(k, v)
        ps.set(k, v)
    JaxSegmenter(js, pattern, tmp_path / "jax.pv", track=False).run()
    pipeline.Segmenter(ps, pattern, tmp_path / "port.pv", track=False,
                       device="cpu").run()
    assert _payload(PVFile, tmp_path / "port.pv") \
        == _payload(JaxPVFile, tmp_path / "jax.pv")
    read = {k: _cv2_read(tmp_path / f"{k}.mov.mp4") for k in ("jax", "port")}
    assert read["port"][1] == read["jax"][1] == (CV2_FOURCC, 16, 25.0, 128,
                                                 96)
    psnr = {k: np.mean([_psnr(cv2.cvtColor(g, cv2.COLOR_BGR2GRAY), f)
                        for g, f in zip(v[0], frames)])
            for k, v in read.items()}
    size = {k: (tmp_path / f"{k}.mov.mp4").stat().st_size for k in read}
    assert size["port"] <= 1.5 * size["jax"], size
    assert psnr["port"] >= psnr["jax"] - 1.0, psnr
    assert vd.refused_variant(tmp_path / "port.mov.mp4") is None


def test_segmenter_raw_movie_without_cv2(tmp_path, monkeypatch):
    """With cv2 blocked, the port's Segmenter records the raw movie at
    save_raw_movie_path, and it decodes to the frames' conversion."""
    from trex_tpu_torch import pipeline
    from trex_tpu_torch.config import reset_global_settings

    frames, pattern = _scene_pngs(tmp_path, 13)
    out = tmp_path / "raw.mp4"
    s = reset_global_settings()
    for k, v in dict(SEG, save_raw_movie_path=str(out)).items():
        s.set(k, v)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setattr(port_video, "_cv2_mod", None)
    pipeline.Segmenter(s, pattern, tmp_path / "p.pv", track=False,
                       device="cpu").run()
    assert not (tmp_path / "p.mov.mp4").exists()
    f = vd.VideoFile(out)
    assert (len(f), f.frame_rate) == (13, 25.0)
    assert min(_psnr(f.read(i, False), frames[i]) for i in range(13)) > 35
    f.close()
