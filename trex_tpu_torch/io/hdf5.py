"""HDF5 files without h5py: the reader and writer of keras ``.h5`` models.

The port's own copy of what ``h5py`` does for ``ml/tagwork.py``, in
plain ``struct`` and numpy (HDF5 file format specification 3.0).

The reader takes what h5py writes by default, which is also what keras
writes: superblock 0, version-1 object headers (continuation messages
and 8-byte aligned messages), symbol-table groups (a version-1 B-tree of
any depth over SNOD nodes, the names in the local heap), attribute
messages of versions 1-3, integer and float datatypes of either byte
order, fixed-length strings with each padding, variable-length strings
from the global heap, scalar and simple dataspaces, contiguous and
compact layouts and a dataset with no storage yet. It also takes
``libver="latest"`` files whose groups keep their links in the object
header: superblock 2/3, ``OHDR`` version-2 headers, link messages
(checksums are not verified).

Attributes are decoded only when asked for, so a file that carries
attributes the reader cannot decode (keras's bools are HDF5 enums)
still opens. A chunked or filtered dataset, a group that keeps its links
in a fractal heap and a datatype the reader is asked to decode and does
not know raise ``ValueError`` naming the feature.

The writer (:func:`writer`) writes superblock 0, symbol-table groups,
contiguous datasets and attributes (fixed-length null-padded strings,
integers and floats): the layout h5py and the JAX package's reader
both take.
"""
from __future__ import annotations

import struct
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE = 0x01, 0x02, 0x03
_FILL, _LINK, _LAYOUT = 0x05, 0x06, 0x08
_FILTERS, _ATTRIBUTE, _CONTINUATION = 0x0B, 0x0C, 0x10
_SYMBOL_TABLE, _ATTRIBUTE_INFO = 0x11, 0x15

_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time",
                3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 9: "variable-length",
                10: "array"}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

class _Datatype:
    """A datatype message, decoded to a numpy dtype on demand."""

    def __init__(self, raw: bytes, shared: bool = False):
        self.raw = raw
        self.shared = shared
        self.cls = raw[0] & 0x0F
        self.bits = raw[1] | (raw[2] << 8) | (raw[3] << 16)
        self.size = struct.unpack_from("<I", raw, 4)[0]

    def _refuse(self, what: str):
        raise ValueError(f"HDF5: unsupported datatype ({what})")

    @property
    def vlen_string(self) -> bool:
        return self.cls == 9 and (self.bits & 0x0F) == 1

    def numpy(self) -> np.dtype:
        if self.shared:
            self._refuse("a shared, committed datatype")
        order = ">" if self.bits & 1 else "<"
        if self.cls == 0:
            if self.size not in (1, 2, 4, 8):
                self._refuse(f"{self.size}-byte integer")
            kind = "i" if self.bits & 0x08 else "u"
            return np.dtype(f"{order}{kind}{self.size}")
        if self.cls == 1:
            if self.bits & 0x40:
                self._refuse("VAX-order float")
            want = {4: (0, 32, 23, 8, 0, 23, 127),
                    8: (0, 64, 52, 11, 0, 52, 1023)}.get(self.size)
            got = struct.unpack_from("<HHBBBBI", self.raw, 8)
            if want is None or got != want:
                self._refuse(f"{self.size}-byte float with layout {got}")
            return np.dtype(f"{order}f{self.size}")
        if self.cls == 3:
            return np.dtype(f"S{self.size}")
        if self.vlen_string:
            return np.dtype(object)
        self._refuse(f"class {self.cls}, {_CLASS_NAMES.get(self.cls, '?')}")


def _dataspace(raw: bytes, size_l: int) -> Optional[tuple]:
    """Shape of a dataspace message; None for the null dataspace."""
    version, rank, _flags = raw[0], raw[1], raw[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if raw[3] == 2:
            return None
        pos = 4
    else:
        raise ValueError(f"HDF5: unsupported dataspace version {version}")
    return tuple(int.from_bytes(raw[pos + i * size_l:pos + (i + 1) * size_l],
                                "little") for i in range(rank))


class _Attribute:
    """An attribute message, parsed to its name; decoded on demand."""

    def __init__(self, f: "File", raw: bytes):
        self.file = f
        version = raw[0]
        name_size, dt_size, ds_size = struct.unpack_from("<HHH", raw, 2)
        self.flags = raw[1] if version > 1 else 0
        if version == 1:
            pos = 8
            name_end = pos + _pad8(name_size)
            dt_end = name_end + _pad8(dt_size)
            ds_end = dt_end + _pad8(ds_size)
        elif version in (2, 3):
            pos = 8 if version == 2 else 9
            name_end = pos + name_size
            dt_end = name_end + dt_size
            ds_end = dt_end + ds_size
        else:
            raise ValueError(f"HDF5: unsupported attribute message "
                             f"version {version}")
        self.name = raw[pos:pos + name_size].split(b"\0", 1)[0].decode()
        self._dt = raw[name_end:name_end + dt_size]
        self._ds = raw[dt_end:dt_end + ds_size]
        self._data = raw[ds_end:]

    def value(self):
        if self.flags & 0x03:
            raise ValueError(f"HDF5: attribute {self.name!r} uses a "
                             "shared datatype or dataspace")
        dt = _Datatype(self._dt)
        shape = _dataspace(self._ds, self.file.size_l)
        if shape is None:
            return None
        return self.file._decode(dt, self._data, shape)


class Attributes:
    """The attributes of an object: a read-only mapping whose values are
    decoded when they are asked for."""

    def __init__(self, obj: "_Object"):
        self._obj = obj

    def _all(self) -> dict:
        return self._obj._attributes()

    def __getitem__(self, name: str):
        return self._all()[name].value()

    def get(self, name: str, default=None):
        a = self._all().get(name)
        return default if a is None else a.value()

    def __contains__(self, name) -> bool:
        return name in self._all()

    def keys(self) -> list:
        return list(self._all())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._all())


class _Object:
    def __init__(self, f: "File", addr: int, name: str):
        self.file = f
        self.addr = addr
        self.name = name
        self._msgs = None
        self._attrs = None

    @property
    def messages(self) -> list:
        if self._msgs is None:
            self._msgs = self.file._header_messages(self.addr)
        return self._msgs

    def _find(self, mtype: int):
        for t, flags, raw in self.messages:
            if t == mtype:
                return flags, raw
        return None

    def _attributes(self) -> dict:
        if self._attrs is None:
            info = self._find(_ATTRIBUTE_INFO)
            if info is not None:
                raw = info[1]
                pos = 2 + (2 if raw[1] & 1 else 0)
                if self.file._addr(raw, pos) is not None:
                    raise ValueError(
                        f"HDF5: {self.name} keeps its attributes densely "
                        "(in a fractal heap), which the reader does not "
                        "take")
            self._attrs = {}
            for t, _flags, raw in self.messages:
                if t == _ATTRIBUTE:
                    a = _Attribute(self.file, raw)
                    self._attrs[a.name] = a
        return self._attrs

    @property
    def attrs(self) -> Attributes:
        return Attributes(self)


class Dataset(_Object):
    """A dataset: ``shape`` and its values (``ds[()]``,
    ``np.asarray(ds)``)."""

    @property
    def shape(self) -> tuple:
        return _dataspace(self._find(_DATASPACE)[1], self.file.size_l)

    def read(self):
        f = self.file
        if self._find(_FILTERS) is not None:
            raise ValueError(f"HDF5: dataset {self.name} is filtered "
                             "(compressed); the reader takes contiguous "
                             "and compact datasets only")
        flags, raw = self._find(_DATATYPE)
        dt = _Datatype(raw, bool(flags & 0x02))
        shape = self.shape
        nbytes = int(np.prod(shape, dtype=np.int64)) * dt.size
        lay = self._find(_LAYOUT)[1]
        version = lay[0]
        if version in (1, 2):
            rank, cls = lay[1], lay[2]
            pos = 8
            if cls in (1, 2):
                addr = f._addr(lay, pos)
                pos += f.size_o
            pos += 4 * rank
        elif version in (3, 4):
            cls = lay[1]
            pos = 2
            if cls == 1:
                addr = f._addr(lay, pos)
        else:
            raise ValueError(f"HDF5: unsupported layout version {version}")
        if cls == 2:
            raise ValueError(f"HDF5: dataset {self.name} is chunked; the "
                             "reader takes contiguous and compact "
                             "datasets only")
        if cls == 0:
            if version < 3:
                size = struct.unpack_from("<I", lay, pos)[0]
                data = lay[pos + 4:pos + 4 + size]
            else:
                size = struct.unpack_from("<H", lay, pos)[0]
                data = lay[pos + 2:pos + 2 + size]
        elif cls == 1:
            if addr is None:
                data = self._fill_value(dt) * (nbytes // max(dt.size, 1))
            else:
                data = f._read(addr, nbytes)
        else:
            raise ValueError(f"HDF5: dataset {self.name} has layout class "
                             f"{cls} (virtual), which the reader does "
                             "not take")
        return f._decode(dt, data, shape)

    def _fill_value(self, dt: _Datatype) -> bytes:
        """One element of the dataset's fill value (zeros by default)."""
        got = self._find(_FILL)
        if got is not None:
            raw = got[1]
            if raw[0] in (1, 2) and (raw[0] == 1 or raw[3]):
                size = struct.unpack_from("<I", raw, 4)[0]
                if size == dt.size:
                    return bytes(raw[8:8 + size])
            elif raw[0] == 3 and raw[1] & 0x20:
                size = struct.unpack_from("<I", raw, 2)[0]
                if size == dt.size:
                    return bytes(raw[6:6 + size])
        return bytes(dt.size)

    def __getitem__(self, key):
        v = self.read()
        return v if key == () or key is Ellipsis else v[key]

    def __array__(self, dtype=None, copy=None):
        v = np.asarray(self.read())
        return v if dtype is None else v.astype(dtype)


class Group(_Object):
    """A group: a mapping of names to groups and datasets; ``g["a/b"]``
    walks a path."""

    def _links(self) -> dict:
        f = self.file
        if getattr(self, "_link_map", None) is not None:
            return self._link_map
        links = {}
        st = self._find(_SYMBOL_TABLE)
        if st is not None:
            btree = f._addr(st[1], 0)
            heap = f._addr(st[1], f.size_o)
            for name, addr in f._symbol_table(btree, heap):
                links[name] = addr
        else:
            info = self._find(_LINK_INFO)
            if info is not None:
                raw = info[1]
                pos = 2 + (8 if raw[1] & 1 else 0)
                if f._addr(raw, pos) is not None:
                    raise ValueError(
                        f"HDF5: group {self.name} keeps its links densely "
                        "(in a fractal heap), which the reader does not "
                        "take")
            for t, _flags, raw in self.messages:
                if t == _LINK:
                    name, addr = f._link(raw)
                    links[name] = addr
        self._link_map = dict(sorted(links.items(),
                                     key=lambda kv: kv[0].encode()))
        return self._link_map

    def keys(self) -> list:
        return list(self._links())

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._links())

    def _child(self, name: str):
        addr = self._links()[name]
        if isinstance(addr, str):
            raise ValueError(f"HDF5: {self.name}/{name} is a {addr} link, "
                             "which the reader does not follow")
        path = f"{self.name.rstrip('/')}/{name}"
        obj = Group(self.file, addr, path)
        kinds = {t for t, _f, _r in obj.messages}
        if _LAYOUT in kinds:
            return Dataset(self.file, addr, path)
        return obj

    def __getitem__(self, path: str):
        obj = self
        for part in str(path).strip("/").split("/"):
            if part:
                if not isinstance(obj, Group):
                    raise KeyError(path)
                obj = obj._child(part)
        return obj

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True


class File(Group):
    """An HDF5 file opened for reading, read into memory whole."""

    def __init__(self, path, mode: str = "r"):
        if mode != "r":
            raise ValueError("HDF5: File opens for reading; use writer() "
                             "to write a file")
        self.buf = Path(path).read_bytes()
        self.path = str(path)
        self._gheaps = {}
        base = 0
        while self.buf[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2
            if base >= len(self.buf):
                raise ValueError(f"{path}: not an HDF5 file")
        b = self.buf
        version = b[base + 8]
        if version in (0, 1):
            self.size_o, self.size_l = b[base + 13], b[base + 14]
            pos = base + (24 if version == 0 else 28)
            self.base = self._int(pos, self.size_o)
            # the root group's symbol table entry, after four addresses
            entry = pos + 4 * self.size_o
            root = self._int(entry + self.size_o, self.size_o)
        elif version in (2, 3):
            self.size_o, self.size_l = b[base + 9], b[base + 10]
            pos = base + 12
            self.base = self._int(pos, self.size_o)
            root = self._int(pos + 3 * self.size_o, self.size_o)
        else:
            raise ValueError(f"HDF5: unsupported superblock version "
                             f"{version}")
        self.undef = (1 << (8 * self.size_o)) - 1
        super().__init__(self, root, "/")

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- primitive reads ------------------------------------------------
    def _int(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos:pos + n], "little")

    def _addr(self, raw: bytes, pos: int) -> Optional[int]:
        """The address at ``raw[pos:]``; None when undefined."""
        a = int.from_bytes(raw[pos:pos + self.size_o], "little")
        return None if a == (1 << (8 * self.size_o)) - 1 else a

    def _read(self, addr: int, n: int) -> bytes:
        a = self.base + addr
        if a + n > len(self.buf):
            raise ValueError(f"HDF5: {self.path} is truncated")
        return self.buf[a:a + n]

    # -- object headers -------------------------------------------------
    def _header_messages(self, addr: int) -> list:
        """[(type, flags, raw)] of the object header at `addr`, the
        continuation blocks followed."""
        b = self.buf
        a = self.base + addr
        out = []
        if b[a:a + 4] == b"OHDR":
            flags = b[a + 5]
            pos = a + 6 + (16 if flags & 0x20 else 0) + \
                (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size = self._int(pos, width)
            pos += width
            blocks = [(pos, pos + size)]
            order = 2 if flags & 0x04 else 0
            while blocks:
                pos, end = blocks.pop(0)
                while pos + 4 + order <= end:
                    t, n, mflags = b[pos], self._int(pos + 1, 2), b[pos + 3]
                    pos += 4 + order
                    raw = b[pos:pos + n]
                    pos += n
                    if t == _CONTINUATION:
                        ca = self.base + self._int_of(raw, 0, self.size_o)
                        cl = self._int_of(raw, self.size_o, self.size_l)
                        if b[ca:ca + 4] != b"OCHK":
                            raise ValueError("HDF5: bad continuation block")
                        blocks.append((ca + 4, ca + cl - 4))
                    else:
                        out.append((t, mflags, raw))
            return out
        if b[a] != 1:
            raise ValueError(f"HDF5: unsupported object header version "
                             f"{b[a]} at {addr}")
        nmsgs = self._int(a + 2, 2)
        size = self._int(a + 8, 4)
        blocks = [(a + 16, a + 16 + size)]
        seen = 0
        while blocks and seen < nmsgs:
            pos, end = blocks.pop(0)
            while pos + 8 <= end and seen < nmsgs:
                t, n, mflags = self._int(pos, 2), self._int(pos + 2, 2), \
                    b[pos + 4]
                raw = b[pos + 8:pos + 8 + n]
                pos += 8 + n
                seen += 1
                if t == _CONTINUATION:
                    ca = self.base + self._int_of(raw, 0, self.size_o)
                    cl = self._int_of(raw, self.size_o, self.size_l)
                    blocks.append((ca, ca + cl))
                else:
                    out.append((t, mflags, raw))
        return out

    @staticmethod
    def _int_of(raw: bytes, pos: int, n: int) -> int:
        return int.from_bytes(raw[pos:pos + n], "little")

    # -- groups ---------------------------------------------------------
    def _symbol_table(self, btree: int, heap: int) -> list:
        """(name, header address) of every entry of a symbol-table group:
        the version-1 B-tree walked at any depth, the SNOD nodes read,
        the names taken from the local heap."""
        so, sl = self.size_o, self.size_l
        h = self.base + heap
        if self.buf[h:h + 4] != b"HEAP":
            raise ValueError("HDF5: bad local heap")
        heap_data = self.base + self._int(h + 8 + 2 * sl, so)

        def name_at(off):
            s = heap_data + off
            return self.buf[s:self.buf.index(b"\0", s)].decode()

        out = []
        stack = [btree]
        while stack:
            node = self.base + stack.pop()
            b = self.buf
            if b[node:node + 4] == b"SNOD":
                n = self._int(node + 6, 2)
                pos = node + 8
                for _ in range(n):
                    out.append((name_at(self._int(pos, so)),
                                self._int(pos + so, so)))
                    pos += 2 * so + 24
                continue
            if b[node:node + 4] != b"TREE" or b[node + 4] != 0:
                raise ValueError("HDF5: bad group B-tree node")
            used = self._int(node + 6, 2)
            pos = node + 8 + 2 * so + sl
            children = []
            for _ in range(used):
                children.append(self._int(pos, so))
                pos += so + sl
            stack.extend(reversed(children))
        return out

    def _link(self, raw: bytes):
        """(name, address or link kind) of a link message."""
        flags = raw[1]
        pos = 2
        kind = 0
        if flags & 0x08:
            kind = raw[pos]
            pos += 1
        if flags & 0x04:
            pos += 8
        if flags & 0x10:
            pos += 1
        width = 1 << (flags & 3)
        n = self._int_of(raw, pos, width)
        pos += width
        name = raw[pos:pos + n].decode()
        pos += n
        if kind == 0:
            return name, self._int_of(raw, pos, self.size_o)
        return name, {1: "soft", 64: "external"}.get(kind, f"type-{kind}")

    # -- values ---------------------------------------------------------
    def _global_heap(self, addr: int) -> dict:
        got = self._gheaps.get(addr)
        if got is not None:
            return got
        sl = self.size_l
        a = self.base + addr
        if self.buf[a:a + 4] != b"GCOL":
            raise ValueError("HDF5: bad global heap collection")
        end = a + self._int(a + 8, sl)
        pos = a + 8 + sl
        objs = {}
        while pos + 8 + sl <= end:
            idx = self._int(pos, 2)
            n = self._int(pos + 8, sl)
            if idx == 0:
                break
            objs[idx] = self.buf[pos + 8 + sl:pos + 8 + sl + n]
            pos += 8 + sl + _pad8(n)
        self._gheaps[addr] = objs
        return objs

    def _decode(self, dt: _Datatype, data: bytes, shape: tuple):
        n = int(np.prod(shape, dtype=np.int64))
        if dt.vlen_string:
            if dt.shared:
                dt.numpy()
            step = 4 + self.size_o + 4
            enc = "utf-8" if (dt.bits >> 8) & 0x0F == 1 else "ascii"
            vals = []
            for i in range(n):
                p = i * step
                length = self._int_of(data, p, 4)
                coll = self._int_of(data, p + 4, self.size_o)
                idx = self._int_of(data, p + 4 + self.size_o, 4)
                raw = self._global_heap(coll)[idx][:length] if length \
                    else b""
                vals.append(raw.decode(enc))
            arr = np.empty(n, object)
            arr[:] = vals
        elif dt.cls == 3:
            pad = dt.bits & 0x0F
            items = [bytes(data[i * dt.size:(i + 1) * dt.size])
                     for i in range(n)]
            if pad == 0:
                items = [s.split(b"\0", 1)[0] for s in items]
            elif pad == 2:
                items = [s.rstrip(b" ") for s in items]
            arr = np.array(items, dtype=np.dtype(f"S{max(dt.size, 1)}"))
        else:
            npdt = dt.numpy()
            arr = np.frombuffer(data, npdt, count=n).copy()
        arr = arr.reshape(shape)
        return arr[()] if arr.ndim == 0 else arr


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

_LEAF_K = 4       # entries of a SNOD node: 2K
_INTERNAL_K = 16  # children of a group B-tree node: 2K
_UNDEF = b"\xff" * 8


class NewGroup:
    """A group to write: ``create_group``, ``create_dataset`` (a path
    makes the groups on its way) and ``attrs``."""

    def __init__(self):
        self.children: dict = {}
        self.attrs: dict = {}

    def create_group(self, path: str) -> "NewGroup":
        g = self
        for part in str(path).strip("/").split("/"):
            nxt = g.children.get(part)
            if nxt is None:
                nxt = g.children[part] = NewGroup()
            if not isinstance(nxt, NewGroup):
                raise ValueError(f"HDF5: {path}: {part} is a dataset")
            g = nxt
        return g

    def create_dataset(self, path: str, data) -> None:
        head, _, name = str(path).strip("/").rpartition("/")
        g = self.create_group(head) if head else self
        if name in g.children:
            raise ValueError(f"HDF5: {path} exists")
        g.children[name] = _NewDataset(np.asarray(data))


class _NewDataset:
    def __init__(self, data: np.ndarray):
        self.data = data
        self.attrs: dict = {}


def _datatype_message(dt: np.dtype) -> bytes:
    if dt.kind == "S":
        # fixed-length, null-padded, ASCII (h5py's numpy "S")
        return struct.pack("<BBBBI", 0x13, 0x01, 0, 0, max(dt.itemsize, 1))
    if dt.kind == "f" and dt.itemsize in (4, 8):
        sign = 31 if dt.itemsize == 4 else 63
        props = (0, 32, 23, 8, 0, 23, 127) if dt.itemsize == 4 else \
            (0, 64, 52, 11, 0, 52, 1023)
        return struct.pack("<BBBBI", 0x11, 0x20, sign, 0, dt.itemsize) + \
            struct.pack("<HHBBBBI", *props)
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        bits = 0x08 if dt.kind == "i" else 0
        return struct.pack("<BBBBI", 0x10, bits, 0, 0, dt.itemsize) + \
            struct.pack("<HH", 0, 8 * dt.itemsize)
    raise ValueError(f"HDF5 writer: unsupported dtype {dt}")


def _dataspace_message(shape: tuple) -> bytes:
    return struct.pack("<BBBBI", 1, len(shape), 0, 0, 0) + \
        b"".join(struct.pack("<Q", int(d)) for d in shape)


def _as_attribute(value) -> np.ndarray:
    """Strings become fixed-length null-padded byte strings, a list of
    them an array; numbers their numpy array, little-endian."""
    if isinstance(value, str):
        value = value.encode()
    if isinstance(value, (list, tuple)) and value and \
            all(isinstance(v, (str, bytes)) for v in value):
        value = [v.encode() if isinstance(v, str) else v for v in value]
        return np.array(value, dtype=f"S{max(1, max(map(len, value)))}")
    arr = np.asarray(value)
    if arr.dtype.kind == "S":
        if arr.dtype.itemsize == 0:
            arr = arr.astype("S1")
        return arr
    if arr.dtype.kind not in "iuf":
        raise ValueError(f"HDF5 writer: unsupported attribute value of "
                         f"dtype {arr.dtype}")
    return arr.astype(arr.dtype.newbyteorder("<"))


def _attribute_message(name: str, value) -> bytes:
    arr = _as_attribute(value)
    nm = name.encode() + b"\0"
    dt = _datatype_message(arr.dtype)
    ds = _dataspace_message(arr.shape)
    data = np.ascontiguousarray(arr).tobytes()
    msg = struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(ds)) + \
        nm.ljust(_pad8(len(nm)), b"\0") + dt.ljust(_pad8(len(dt)), b"\0") + \
        ds.ljust(_pad8(len(ds)), b"\0") + data
    if len(msg) > 0xFFF0:
        raise ValueError(f"HDF5 writer: attribute {name!r} is larger than "
                         "an object header message can hold (64 KiB)")
    return msg


class _Out:
    def __init__(self):
        self.buf = bytearray()

    def alloc(self, data: bytes) -> int:
        """Append `data` at the next 8-byte boundary; its address."""
        self.buf.extend(b"\0" * (_pad8(len(self.buf)) - len(self.buf)))
        addr = len(self.buf)
        self.buf.extend(data)
        return addr


def _object_header(msgs: list) -> bytes:
    """A version-1 object header over [(type, data)]."""
    body = b""
    for t, data in msgs:
        data = data.ljust(_pad8(len(data)), b"\0")
        body += struct.pack("<HHB3x", t, len(data), 0) + data
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _write_dataset(out: _Out, ds: _NewDataset) -> int:
    arr = ds.data
    if arr.dtype.kind not in "iufS":
        raise ValueError(f"HDF5 writer: unsupported dataset dtype "
                         f"{arr.dtype}")
    if arr.dtype.kind != "S":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    raw = np.ascontiguousarray(arr).tobytes()
    addr = struct.pack("<Q", out.alloc(raw)) if raw else _UNDEF
    layout = struct.pack("<BB", 3, 1) + addr + struct.pack("<Q", len(raw))
    msgs = [(_DATASPACE, _dataspace_message(arr.shape)),
            (_DATATYPE, _datatype_message(arr.dtype)),
            # fill value message v2: allocation late, written if set, none
            (_FILL, struct.pack("<BBBB", 2, 2, 2, 0)),
            (_LAYOUT, layout)]
    msgs += [(_ATTRIBUTE, _attribute_message(k, v))
             for k, v in ds.attrs.items()]
    return out.alloc(_object_header(msgs))


def _write_group(out: _Out, g: NewGroup) -> tuple:
    """Write `g` and its subtree; (header, B-tree, local heap) addresses."""
    names = sorted(g.children, key=str.encode)
    addrs = {}
    for name in names:
        child = g.children[name]
        addrs[name] = _write_group(out, child)[0] \
            if isinstance(child, NewGroup) else _write_dataset(out, child)
    # local heap: "" at offset 0, then each name, 8-byte aligned
    heap = bytearray(8)
    offsets = {}
    for name in names:
        offsets[name] = len(heap)
        nm = name.encode() + b"\0"
        heap.extend(nm.ljust(_pad8(len(nm)), b"\0"))
    heap_data = out.alloc(bytes(heap))
    heap_addr = out.alloc(b"HEAP" + bytes(4) + struct.pack(
        "<QQQ", len(heap), 1, heap_data))   # free list: none (1)
    # SNOD leaves of at most 2K entries, in name order
    snod_size = 8 + 2 * _LEAF_K * 40
    level = []   # (address, right key offset) per node of this level
    for s in range(0, max(len(names), 1), 2 * _LEAF_K):
        chunk = names[s:s + 2 * _LEAF_K]
        body = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk))
        for name in chunk:
            body += struct.pack("<QQII16x", offsets[name], addrs[name], 0, 0)
        level.append((out.alloc(body.ljust(snod_size, b"\0")),
                      offsets[chunk[-1]] if chunk else 0))
    depth = 0
    node_size = 8 + 16 + (2 * _INTERNAL_K + 1) * 8 + 2 * _INTERNAL_K * 8
    while True:
        nodes = []
        for s in range(0, len(level), 2 * _INTERNAL_K):
            kids = level[s:s + 2 * _INTERNAL_K]
            used = len(kids) if names else 0
            body = b"TREE" + struct.pack("<BBH", 0, depth, used) + \
                _UNDEF + _UNDEF + struct.pack("<Q", 0)
            for addr, key in kids[:used]:
                body += struct.pack("<QQ", addr, key)
            nodes.append((out.alloc(body.ljust(node_size, b"\0")),
                          kids[-1][1]))
        if len(nodes) == 1:
            btree = nodes[0][0]
            break
        level = nodes
        depth += 1
    msgs = [(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))]
    msgs += [(_ATTRIBUTE, _attribute_message(k, v))
             for k, v in g.attrs.items()]
    return out.alloc(_object_header(msgs)), btree, heap_addr


def write(path, root: NewGroup) -> None:
    """Write the tree under `root` as an HDF5 file (superblock 0)."""
    out = _Out()
    out.buf.extend(bytes(96))
    header, btree, heap = _write_group(out, root)
    eof = _pad8(len(out.buf))
    out.buf.extend(bytes(eof - len(out.buf)))
    sb = SIGNATURE + struct.pack("<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0,
                                 _LEAF_K, _INTERNAL_K, 0)
    sb += struct.pack("<Q", 0) + _UNDEF + struct.pack("<Q", eof) + _UNDEF
    # the root group's symbol table entry, its B-tree and heap cached
    sb += struct.pack("<QQII", 0, header, 1, 0) + \
        struct.pack("<QQ", btree, heap)
    out.buf[:96] = sb
    Path(path).write_bytes(bytes(out.buf))


@contextmanager
def writer(path):
    """``with writer(path) as root:`` fill `root` (a :class:`NewGroup`);
    the file is written when the block ends without an error."""
    root = NewGroup()
    yield root
    write(path, root)
