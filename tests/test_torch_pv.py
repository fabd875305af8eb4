"""The port's container I/O (trex_tpu_torch/io/: lzo, pv, predictions,
encoding, patharray) against the JAX package's: the LZO codec and the
.pv bytes each writes, each package reading the other's files, the
illegal-line correction, the index table, fix_file and merge_files.
Bytes compare exactly; there is no tolerance."""
import numpy as np
import pytest

from trex_tpu.config import reset_global_settings as jax_reset
from trex_tpu.io import encoding as jax_enc
from trex_tpu.io import lzo as jax_lzo
from trex_tpu.io import patharray as jax_pa
from trex_tpu.io import pv as jax_pv
from trex_tpu.io.predictions import Prediction as JaxPrediction
from trex_tpu_torch.config import reset_global_settings
from trex_tpu_torch.io import encoding as port_enc
from trex_tpu_torch.io import lzo
from trex_tpu_torch.io import patharray as port_pa
from trex_tpu_torch.io import pv
from trex_tpu_torch.io.predictions import Prediction

TIMESTAMP = 1_700_000_000_123_456  # pinned: the writer stamps wall time


def _payloads():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "one": b"\x07",
        "zeros": bytes(5000),
        "random": rng.integers(0, 256, 7000, np.uint8).tobytes(),
        "runs": np.repeat(rng.integers(0, 256, 400, np.uint8),
                          rng.integers(1, 40, 400)).tobytes(),
        "text": b"trex pv frame payload " * 300,
        "ramp": (np.arange(20000) % 251).astype(np.uint8).tobytes(),
    }


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_lzo_equals_jax_and_each_reads_the_other(name):
    data = _payloads()[name]
    comp = lzo.compress(data)
    assert comp == jax_lzo.compress(data)
    assert jax_lzo.decompress(comp, len(data)) == data
    assert lzo.decompress(jax_lzo.compress(data), len(data)) == data


def test_lzo_corrupt_stream_raises():
    comp = lzo.compress(b"abc" * 1000)
    with pytest.raises(lzo.LZOError):
        lzo.decompress(comp[: len(comp) // 2], 3000)


def _frames(mod, pred_cls, encoding, n=6, seed=1):
    rng = np.random.default_rng(seed)
    ch = mod.storage_channels(encoding)
    frames = []
    for i in range(n):
        fr = mod.PVFrame(timestamp=40_000 * (i + 1), source_index=i,
                         index=i)
        k = 3 + i % 4
        for j in range(k):
            y0 = int(rng.integers(0, 100))
            rows = int(rng.integers(1, 30 if i == 2 else 6))
            lines = []
            for r in range(rows):
                x0 = int(rng.integers(0, 100))
                lines.append([y0 + r, x0, x0 + int(rng.integers(0, 20))])
            lines = np.asarray(lines, np.int32)
            npx = int(np.sum(lines[:, 2] - lines[:, 1] + 1))
            px = rng.integers(0, 256, npx * max(ch, 1), np.uint8) \
                if ch else None
            fr.add_object(lines, px, flags=int(j == 1))
        if i == 3:
            fr.predictions = [pred_cls(
                clid=j, p=0.5 + 0.1 * j,
                pose=np.array([[j, 2], [3, 4]], np.uint16),
                outlines=[np.array([1, 2, 3], np.int32)],
                original_outline=np.array([5, 6], np.int32))
                for j in range(fr.n)]
        frames.append(fr)
    return frames


def _write(mod, pred_cls, path, encoding, frames=None):
    rng = np.random.default_rng(2)
    ch = mod.average_channels(encoding)
    avg = rng.integers(0, 256, (128, 120, ch), np.uint8)
    h = mod.PVHeader(encoding=encoding, width=120, height=128,
                     average=avg[..., 0] if ch == 1 else avg,
                     name="clip", timestamp=TIMESTAMP, conversion_start=0,
                     conversion_end=5, source="synthetic",
                     mask=(avg[..., 0] > 100).astype(np.uint8))
    with mod.PVFile.create(path, h) as f:
        f.set_metadata({"frame_rate": 25, "cm_per_pixel": 0.05,
                        "track_size_filter": [[1, 100]]})
        for fr in frames or _frames(mod, pred_cls, encoding):
            f.add_frame(fr)
    return path.read_bytes()


def _assert_frames_equal(a, b):
    assert (a.timestamp, a.source_index, a.n, list(a.flags)) \
        == (b.timestamp, b.source_index, b.n, list(b.flags))
    for ma, mb, pa, pb in zip(a.masks, b.masks, a.pixels, b.pixels):
        np.testing.assert_array_equal(ma, mb)
        if pa is None:
            assert pb is None
        else:
            np.testing.assert_array_equal(pa, pb)
    assert len(a.predictions) == len(b.predictions)
    for x, y in zip(a.predictions, b.predictions):
        if x is None:
            assert y is None
            continue
        assert (x.clid, x.p) == (y.clid, y.p)
        np.testing.assert_array_equal(x.pose, y.pose)
        np.testing.assert_array_equal(x.original_outline,
                                      y.original_outline)


@pytest.mark.parametrize("encoding", ["gray", "rgb8", "r3g3b2", "binary"])
def test_pv_bytes_equal_jax_and_each_reads_the_other(tmp_path, encoding):
    port_bytes = _write(pv, Prediction, tmp_path / "port.pv", encoding)
    jax_bytes = _write(jax_pv, JaxPrediction, tmp_path / "jax.pv",
                       encoding)
    assert port_bytes == jax_bytes
    with pv.PVFile.open(tmp_path / "jax.pv") as a, \
            jax_pv.PVFile.open(tmp_path / "port.pv") as b:
        assert a.header.timestamp == b.header.timestamp == TIMESTAMP
        assert (a.header.num_frames, a.header.index_table,
                a.header.metadata, a.header.average_tdelta) \
            == (b.header.num_frames, b.header.index_table,
                b.header.metadata, b.header.average_tdelta)
        np.testing.assert_array_equal(a.header.average, b.header.average)
        np.testing.assert_array_equal(a.header.mask, b.header.mask)
        assert a.header.metadata_dict() == b.header.metadata_dict()
        for i in range(len(a)):
            _assert_frames_equal(a.read_frame(i), b.read_frame(i))
        # random access through the index table, in any order
        for i in (4, 0, 5, 2):
            _assert_frames_equal(a.read_frame(i), b.read_frame(i))


def test_pv_frame_payload_equals_jax():
    for i, (a, b) in enumerate(zip(_frames(pv, Prediction, "gray"),
                                   _frames(jax_pv, JaxPrediction, "gray"))):
        assert pv.serialize_frame(a, "gray") \
            == jax_pv.serialize_frame(b, "gray"), i


def test_correct_illegal_lines_equals_jax(tmp_path):
    """Overlapping lines from old writers: read verbatim by default, and
    sorted, clamped and re-sliced with correct_illegal_lines, as the JAX
    package reads them (tests/test_pv.py)."""
    bg = np.full((20, 20), 99, np.uint8)
    p = tmp_path / "ill.pv"
    with pv.PVFile.create(p, pv.PVHeader(width=20, height=20, average=bg,
                                         timestamp=TIMESTAMP)) as f:
        fr = pv.PVFrame(timestamp=100)
        lines = np.array([[4, 1, 3], [5, 2, 8], [5, 6, 10]], np.int32)
        px = np.arange(3 + 7 + 5).astype(np.uint8)
        fr.add_object(lines, px)
        f.add_frame(fr)
    for on in (False, True):
        s, sj = reset_global_settings(), jax_reset()
        s.set("correct_illegal_lines", on)
        sj.set("correct_illegal_lines", on)
        with pv.PVFile.open(p) as a, jax_pv.PVFile.open(p) as b:
            fa, fb = a.read_frame(0), b.read_frame(0)
        _assert_frames_equal(fa, fb)
        if on:
            assert fa.masks[0].tolist() == [[4, 1, 3], [5, 2, 8],
                                            [5, 9, 10]]
        else:
            assert fa.masks[0].shape == (3, 3)
    reset_global_settings()
    jax_reset()


def test_fix_and_merge_equal_jax(tmp_path):
    _write(pv, Prediction, tmp_path / "a.pv", "gray")
    data = bytearray((tmp_path / "a.pv").read_bytes())
    with pv.PVFile.open(tmp_path / "a.pv") as f:
        third = f.header.index_table[2]
    # a broken frame: its payload's object count points past the data
    data[third + 9:third + 11] = b"\xff\xff"
    for name in ("port", "jax"):
        (tmp_path / f"{name}_broken.pv").write_bytes(bytes(data))
    got = pv.fix_file(tmp_path / "port_broken.pv", tmp_path / "port_fix.pv")
    want = jax_pv.fix_file(tmp_path / "jax_broken.pv",
                           tmp_path / "jax_fix.pv")
    assert got == want == (5, 1)
    assert (tmp_path / "port_fix.pv").read_bytes() \
        == (tmp_path / "jax_fix.pv").read_bytes()

    _write(pv, Prediction, tmp_path / "b.pv", "gray",
           frames=_frames(pv, Prediction, "gray", n=3, seed=9))
    ins = [tmp_path / "a.pv", tmp_path / "b.pv"]
    for name in ("port", "jax"):
        (tmp_path / name).mkdir()
    assert pv.merge_files(tmp_path / "port" / "m.pv", ins) \
        == jax_pv.merge_files(tmp_path / "jax" / "m.pv", ins) == 9
    assert (tmp_path / "port" / "m.pv").read_bytes() \
        == (tmp_path / "jax" / "m.pv").read_bytes()


def test_encodings_equal_jax():
    rng = np.random.default_rng(4)
    bgr = rng.integers(0, 256, (17, 23, 3), np.uint8)
    packed = port_enc.bgr_to_r3g3b2(bgr)
    np.testing.assert_array_equal(packed, jax_enc.bgr_to_r3g3b2(bgr))
    for enc in ("gray", "rgb8", "r3g3b2"):
        img = bgr if enc != "gray" else bgr[..., 0]
        a = port_enc.convert_to_storage(img, enc)
        np.testing.assert_array_equal(a, jax_enc.convert_to_storage(img,
                                                                    enc))
        np.testing.assert_array_equal(port_enc.storage_to_gray(a, enc),
                                      jax_enc.storage_to_gray(a, enc))
        np.testing.assert_array_equal(
            port_enc.decode_background(a, enc),
            jax_enc.decode_background(a, enc))


@pytest.mark.parametrize("pattern", [
    "f_%03d.png", "f_%1.3.03d.png", "f_*.png", '["f_000.png","f_002.png"]',
    "plain.png"])
def test_patharray_equals_jax(tmp_path, pattern):
    for i in range(5):
        (tmp_path / f"f_{i:03d}.png").write_bytes(b"x")
    (tmp_path / "plain.png").write_bytes(b"x")
    full = pattern if pattern.startswith("[") else str(tmp_path / pattern)
    if pattern.startswith("["):
        full = full.replace('"f_', f'"{tmp_path}/f_')
    assert port_pa.has_pattern(full) == jax_pa.has_pattern(full)
    if port_pa.has_pattern(full):
        got = port_pa.resolve_paths(full)
        assert got == jax_pa.resolve_paths(full)
        assert port_pa.find_basename(got) == jax_pa.find_basename(got)
        assert port_pa.sanitize_filename(port_pa.find_basename(got)) \
            == jax_pa.sanitize_filename(jax_pa.find_basename(got))
