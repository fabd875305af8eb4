"""The port's HDF5 reader and writer (trex_tpu_torch/io/hdf5.py) held to
h5py: the reader on files h5py writes (default and libver="latest"),
h5py on files the writer writes, and each refusal."""
import json

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from trex_tpu_torch.io import hdf5


def _norm(v):
    """h5py and the port decode strings to str or bytes differently per
    kind; compare values as numpy arrays of str / numbers."""
    if isinstance(v, (bytes, np.bytes_)):
        return v.decode()
    if isinstance(v, str):
        return v
    a = np.asarray(v)
    if a.dtype.kind in "SO":
        return [x.decode() if isinstance(x, bytes) else x
                for x in a.ravel().tolist()], a.shape
    return a


def _assert_same(a, b):
    na, nb = _norm(a), _norm(b)
    if isinstance(na, np.ndarray):
        assert isinstance(nb, np.ndarray)
        assert na.shape == nb.shape and na.dtype == nb.dtype
        np.testing.assert_array_equal(na, nb)
    else:
        assert na == nb


def _walk_equal(hg, pg):
    """Every attribute, group and dataset of h5py's `hg` equals the
    port's `pg` (tolerance 0)."""
    assert sorted(hg.attrs.keys()) == sorted(pg.attrs.keys())
    for k in hg.attrs.keys():
        _assert_same(hg.attrs[k], pg.attrs[k])
    assert list(hg.keys()) == pg.keys()
    for k in hg.keys():
        h, p = hg[k], pg[k]
        if isinstance(h, h5py.Group):
            assert isinstance(p, hdf5.Group)
            _walk_equal(h, p)
        else:
            assert isinstance(p, hdf5.Dataset)
            assert p.shape == h.shape
            _assert_same(h[()], p[()])


def _write_mixed(path, libver=None):
    kw = {"libver": "latest"} if libver else {}
    rng = np.random.default_rng(0)
    with h5py.File(path, "w", **kw) as f:
        f.attrs["vlen_scalar"] = "a variable-length string"
        f.attrs["vlen_array"] = ["x", "yy", "zzz"]
        f.attrs["fixed_array"] = np.array([b"ab", b"c", b""])
        f.attrs["fixed_scalar"] = np.bytes_(b"fixed")
        f.attrs["f64"] = np.float64(3.25)
        f.attrs["i32_array"] = np.arange(4, dtype=np.int32)
        g = f.create_group("a/b/c")
        g.attrs["depth"] = np.int64(3)
        g.create_dataset("f32_r0", data=np.float32(1.5))
        g.create_dataset("f64_r1", data=rng.normal(size=7))
        g.create_dataset("i16_r2", data=rng.integers(-9, 9, (3, 4),
                                                     dtype=np.int16))
        g.create_dataset("u8_r3", data=rng.integers(0, 255, (2, 3, 4),
                                                    dtype=np.uint8))
        g.create_dataset("f32_r4", data=rng.normal(
            size=(2, 3, 1, 2)).astype(np.float32))
        # at most 8 links a group: libver="latest" keeps more densely
        g = f.create_group("a/d")
        g.create_dataset("big_endian", data=np.arange(5, dtype=">i4"))
        g.create_dataset("empty", shape=(0, 3), dtype=np.float32)
        g.create_dataset("unwritten", shape=(4,), dtype=np.int32)
        g.create_dataset("filled", shape=(3,), dtype=np.float32,
                         fillvalue=7.0)
        f.create_dataset("strings", data=np.array([b"one", b"three"]))


@pytest.mark.parametrize("libver", [None, "latest"])
def test_reader_equals_h5py(tmp_path, libver):
    path = tmp_path / "m.h5"
    _write_mixed(path, libver)
    with h5py.File(path, "r") as hf, hdf5.File(path) as pf:
        _walk_equal(hf, pf)


def test_reader_splits_btree_of_a_large_group(tmp_path):
    """More entries than one SNOD (2K = 8) and one B-tree node (2K = 32)
    hold: the B-tree has more than one level."""
    path = tmp_path / "big.h5"
    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        for i in range(300):
            g.create_dataset(f"layer_{i:03d}/kernel:0",
                             data=np.full(2, i, np.float32))
    with h5py.File(path, "r") as hf, hdf5.File(path) as pf:
        assert len(pf["model_weights"]) == 300
        _walk_equal(hf, pf)
    with hdf5.File(path) as pf:
        np.testing.assert_array_equal(
            pf["model_weights/layer_299/kernel:0"][()], [299, 299])


def test_reader_keras2_style_attributes(tmp_path):
    """keras 2's layout: `model_config` a scalar bytes attribute (h5py
    stores it as a variable-length string), `layer_names` and
    `weight_names` numpy S arrays (fixed-length, null-padded), bools
    (HDF5 enums) and an `optimizer_weights` group the reader never
    decodes."""
    path = tmp_path / "k.h5"
    cfg = json.dumps({"class_name": "Sequential", "config": {"layers": []}})
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = cfg.encode()
        f.attrs["training_config"] = json.dumps({"loss": "x"}).encode()
        f.attrs["keras_version"] = b"2.4.0"
        f.attrs["backend"] = b"tensorflow"
        f.attrs["flag"] = np.bool_(True)
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([b"dense", b"flatten"])
        g = mw.create_group("dense")
        g.attrs["weight_names"] = np.array([b"dense/kernel:0",
                                            b"dense/bias:0"])
        g.create_dataset("dense/kernel:0", data=np.ones((3, 2), "f4"))
        g.create_dataset("dense/bias:0", data=np.zeros(2, "f4"))
        f.create_group("optimizer_weights").attrs["weight_names"] = \
            np.array([b"Adam/iter:0"])
    with hdf5.File(path) as pf:
        raw = pf.attrs.get("model_config")
        assert raw == cfg
        names = pf["model_weights/dense"].attrs["weight_names"]
        assert names.dtype.kind == "S"
        assert [n.decode() for n in names] == ["dense/kernel:0",
                                              "dense/bias:0"]
        np.testing.assert_array_equal(pf["model_weights/dense"][
            "dense/kernel:0"][()], np.ones((3, 2), "f4"))
        with pytest.raises(ValueError, match="enum"):
            pf.attrs["flag"]


@pytest.mark.parametrize("pad", ["nullterm", "nullpad", "spacepad"])
def test_reader_fixed_strings_each_padding(tmp_path, pad):
    path = tmp_path / f"{pad}.h5"
    strpad = {"nullterm": h5py.h5t.STR_NULLTERM,
              "nullpad": h5py.h5t.STR_NULLPAD,
              "spacepad": h5py.h5t.STR_SPACEPAD}[pad]
    words = [b"ab", b"abcde", b"x"]
    with h5py.File(path, "w") as f:
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(6)
        tid.set_strpad(strpad)
        space = h5py.h5s.create_simple((3,))
        aid = h5py.h5a.create(f.id, b"words", tid, space)
        padded = [w + (b" " if pad == "spacepad" else b"\0") * (6 - len(w))
                  for w in words]
        aid.write(np.array(padded, dtype="S6"), mtype=tid)
    with hdf5.File(path) as pf:
        got = [w for w in pf.attrs["words"]]
    assert got == words


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(shape=st.lists(st.integers(0, 4), min_size=0, max_size=4),
       dtype=st.sampled_from(["<f4", "<f8", "<i4", "<u2", ">f8", "<i8"]),
       seed=st.integers(0, 2 ** 16),
       latest=st.booleans())
def test_reader_datasets_under_hypothesis(tmp_path_factory, shape, dtype,
                                          seed, latest):
    path = tmp_path_factory.mktemp("h") / "d.h5"
    data = (np.random.default_rng(seed).normal(size=shape) * 100
            ).astype(dtype)
    kw = {"libver": "latest"} if latest else {}
    with h5py.File(path, "w", **kw) as f:
        f.create_dataset("g/d", data=data)
        f["g"].attrs["a"] = data if data.size else np.float64(1)
    with h5py.File(path, "r") as hf, hdf5.File(path) as pf:
        _walk_equal(hf, pf)


def test_h5py_reads_the_writers_files(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "w.h5"
    arrays = {f"model_weights/l{i}/l{i}/kernel:0":
              rng.normal(size=(3, 3, 1, i + 1)).astype(np.float32)
              for i in range(45)}
    arrays["other/ints"] = np.arange(6, dtype=np.int64).reshape(2, 3)
    arrays["other/scalar"] = np.float64(2.5)
    arrays["other/empty"] = np.zeros((0,), np.float32)
    with hdf5.writer(path) as root:
        root.attrs["model_config"] = json.dumps({"a": [1, 2]})
        root.attrs["numbers"] = np.arange(3, dtype=np.float32)
        for k, v in arrays.items():
            root.create_dataset(k, v)
        mw = root.create_group("model_weights")
        mw.attrs["layer_names"] = [f"l{i}".encode() for i in range(45)]
        mw.create_group("l0").attrs["weight_names"] = []
    with h5py.File(path, "r") as f:
        assert f.attrs["model_config"] == b'{"a": [1, 2]}'
        np.testing.assert_array_equal(f.attrs["numbers"], [0, 1, 2])
        assert len(f["model_weights"]) == 45
        assert list(f["model_weights"].attrs["layer_names"]) == \
            [f"l{i}".encode() for i in range(45)]
        assert len(f["model_weights/l0"].attrs["weight_names"]) == 0
        for k, v in arrays.items():
            got = f[k][()]
            assert np.asarray(got).dtype == v.dtype
            np.testing.assert_array_equal(got, v)
        with hdf5.File(path) as pf:
            _walk_equal(f, pf)


def test_refuses_chunked_and_filtered_datasets(tmp_path):
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("chunked", data=np.arange(10), chunks=(5,))
        f.create_dataset("gzip", data=np.arange(10), compression="gzip")
    with hdf5.File(path) as pf:
        with pytest.raises(ValueError, match="chunked"):
            pf["chunked"][()]
        with pytest.raises(ValueError, match="filtered"):
            pf["gzip"][()]


def test_refuses_dense_link_storage(tmp_path):
    path = tmp_path / "dense.h5"
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("g")
        for i in range(20):
            g.create_dataset(f"d{i}", data=np.arange(2))
    with hdf5.File(path) as pf:
        with pytest.raises(ValueError, match="fractal heap"):
            pf["g"].keys()


def test_refuses_unknown_datatype_only_when_asked(tmp_path):
    path = tmp_path / "t.h5"
    with h5py.File(path, "w") as f:
        f.attrs["compound"] = np.array([(1, 2.0)],
                                       dtype=[("a", "i4"), ("b", "f8")])
        f.attrs["ok"] = np.int32(5)
        f.create_dataset("cmp", data=np.zeros(2, dtype=[("a", "i2")]))
    with hdf5.File(path) as pf:
        assert pf.attrs["ok"] == 5
        with pytest.raises(ValueError, match="compound"):
            pf.attrs["compound"]
        with pytest.raises(ValueError, match="compound"):
            pf["cmp"][()]


def test_writer_refuses_oversized_attribute(tmp_path):
    with pytest.raises(ValueError, match="64 KiB"):
        with hdf5.writer(tmp_path / "x.h5") as root:
            root.attrs["huge"] = "x" * 70000


@pytest.mark.parametrize("libver", [None, "latest"])
def test_reader_compact_layout(tmp_path, libver):
    """A dataset whose values live in its object header (compact)."""
    path = tmp_path / "compact.h5"
    kw = {"libver": "latest"} if libver else {}
    data = np.arange(12, dtype="<f8").reshape(3, 4)
    with h5py.File(path, "w", **kw) as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        space = h5py.h5s.create_simple(data.shape)
        dsid = h5py.h5d.create(f.id, b"c", h5py.h5t.IEEE_F64LE, space,
                               dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    with h5py.File(path, "r") as hf, hdf5.File(path) as pf:
        assert hf["c"].id.get_create_plist().get_layout() == \
            h5py.h5d.COMPACT
        _walk_equal(hf, pf)
        np.testing.assert_array_equal(pf["c"][()], data)
