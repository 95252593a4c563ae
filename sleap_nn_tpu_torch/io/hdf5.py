"""The subset of HDF5 that ``.slp`` and analysis files use, in plain Python.

The JAX package reads and writes these files with h5py. The port keeps its
own reader and writer instead (numpy, ``zlib`` and ``mmap``), with a small
``File`` / ``Group`` / ``Dataset`` / ``attrs`` surface in h5py's shape, so
that the files are the same and no HDF5 library is needed.

The writer writes what h5py writes by default (``libver="earliest"``), so
that HDF5 1.8-era readers open its files as they open SLEAP v1 files:

- superblock version 0, version 1 object headers (8-byte aligned
  messages), symbol-table groups (a version 1 B-tree over symbol-table
  leaves of at most ``2 * K`` = 8 entries, sorted by name, plus a local
  heap);
- contiguous datasets, and chunked datasets with deflate (one chunk a
  dataset); scalar, simple and empty dataspaces (an empty dataset has an
  undefined address);
- little-endian integers and floats, null-padded fixed-length ``S``
  strings, compound types at numpy's offsets, numpy ``bool`` as h5py's
  enum (int8 base, ``FALSE`` = 0, ``TRUE`` = 1);
- variable-length ``uint8`` sequences and UTF-8 strings, whose elements
  are 16-byte ``(length, collection address, index)`` records into
  global heap collections of at least 4096 bytes;
- attributes on groups and datasets.

The reader reads all of that, and files that h5py writes with
``libver="latest"`` (superblock 2/3, ``OHDR`` version 2 headers, compact
link storage, version 4 layouts with single-chunk, implicit, fixed-array
and extensible-array chunk indexes), chunked datasets with
``maxshape=(None, ...)`` (a version 1 B-tree index, or with
``libver="latest"`` an extensible array), ``gzip`` at any level,
``shuffle``, chunks that do not divide the shape and object header
continuation blocks. An int or a step-1 slice of the first axis reads
only the bytes of those rows, or of a chunked dataset only the chunks
that hold them (the chunk index is read once a dataset). A feature
outside this subset raises ``NotImplementedError`` naming itself; the
reader never returns wrong data.
"""

from __future__ import annotations

import bisect
import mmap
import os
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_LEAF_K = 4  # symbol-table leaf K: at most 2K entries a leaf
_GROUP_NODE_K = 16  # group B-tree internal K: at most 2K children a node
_CHUNK_NODE_K = 32  # chunk B-tree K (the default of superblock 0)
_MIN_COLLECTION = 4096
_MAX_COLLECTION_PAYLOAD = 1 << 20


def vlen_dtype(base) -> np.dtype:
    """An object dtype that holds variable-length sequences of ``base``
    (h5py's ``vlen_dtype``)."""
    return np.dtype("O", metadata={"vlen": np.dtype(base)})


def string_dtype() -> np.dtype:
    """An object dtype of variable-length UTF-8 strings (h5py's
    ``string_dtype()``)."""
    return np.dtype("O", metadata={"vlen": str})


def check_vlen_dtype(dt: np.dtype):
    """The base of a variable-length dtype, else None (h5py's
    ``check_vlen_dtype``)."""
    return (dt.metadata or {}).get("vlen") if dt.kind == "O" else None


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---------------------------------------------------------------------------
# Datatypes
# ---------------------------------------------------------------------------


class _Type:
    """A decoded HDF5 datatype: its numpy dtype and, for a variable-length
    type, what an element holds (``"str"`` or the base dtype)."""

    def __init__(self, dtype: np.dtype, size: int, vlen=None):
        self.dtype = dtype
        self.size = size
        self.vlen = vlen


def _decode_type(buf, off: int) -> Tuple[_Type, int]:
    """Decode a datatype message at ``off``; returns it and its length."""
    cv = buf[off]
    cls, version = cv & 0x0F, cv >> 4
    b0, b1, b2 = buf[off + 1], buf[off + 2], buf[off + 3]
    size = struct.unpack_from("<I", buf, off + 4)[0]
    p = off + 8
    if cls == 0:  # fixed point
        if b0 & 1:
            raise NotImplementedError("HDF5 big-endian datatype")
        offset, prec = struct.unpack_from("<HH", buf, p)
        if offset or prec != 8 * size or size not in (1, 2, 4, 8):
            raise NotImplementedError(
                f"HDF5 integer datatype with bit offset {offset} and precision {prec}")
        kind = "i" if b0 & 0x08 else "u"
        return _Type(np.dtype(f"<{kind}{size}"), size), 12
    if cls == 1:  # floating point
        if b0 & 1 or b0 & 0x40:
            raise NotImplementedError("HDF5 big-endian datatype")
        offset, prec, eloc, esize, mloc, msize = struct.unpack_from("<HHBBBB", buf, p)
        bias = struct.unpack_from("<I", buf, p + 8)[0]
        ieee = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
                8: (63, 52, 11, 0, 52, 1023)}.get(size)
        if ieee is None or (b1, eloc, esize, mloc, msize, bias) != ieee or offset \
                or prec != 8 * size or (b0 >> 4) & 3 != 2:
            raise NotImplementedError(f"HDF5 non-IEEE {size}-byte float datatype")
        return _Type(np.dtype(f"<f{size}"), size), 20
    if cls == 3:  # fixed-length string
        return _Type(np.dtype(f"S{size}"), size), 8
    if cls == 6:  # compound
        n = b0 | (b1 << 8)
        names, formats, offsets = [], [], []
        for _ in range(n):
            end = buf.find(b"\x00", p)
            name = bytes(buf[p:end]).decode()
            if version < 3:
                p += _pad8(end - p + 1)
                moff = struct.unpack_from("<I", buf, p)[0]
                p += 4
                if version == 1:
                    if buf[p]:
                        raise NotImplementedError("HDF5 array member of a compound datatype")
                    p += 28
            else:
                p = end + 1
                nb = 1 if size < 1 << 8 else 2 if size < 1 << 16 else 3 if size < 1 << 24 else 4
                moff = int.from_bytes(bytes(buf[p:p + nb]), "little")
                p += nb
            mtype, mlen = _decode_type(buf, p)
            p += mlen
            if mtype.vlen is not None:
                raise NotImplementedError("HDF5 variable-length member of a compound datatype")
            names.append(name)
            formats.append(mtype.dtype)
            offsets.append(moff)
        dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                       "itemsize": size})
        return _Type(dt, size), p - off
    if cls == 8:  # enumeration
        n = b0 | (b1 << 8)
        base, blen = _decode_type(buf, p)
        p += blen
        names = []
        for _ in range(n):
            end = buf.find(b"\x00", p)
            names.append(bytes(buf[p:end]).decode())
            p = p + _pad8(end - p + 1) if version < 3 else end + 1
        values = np.frombuffer(bytes(buf[p:p + n * base.size]), base.dtype).tolist()
        p += n * base.size
        mapping = dict(zip(names, values))
        if base.dtype == np.int8 and mapping == {"FALSE": 0, "TRUE": 1}:
            return _Type(np.dtype("?"), size), p - off
        return _Type(base.dtype, size), p - off
    if cls == 9:  # variable length
        base, blen = _decode_type(buf, p)
        kind = "str" if b0 & 0x0F == 1 else base.dtype
        if kind != "str" and base.vlen is not None:
            raise NotImplementedError("HDF5 nested variable-length datatype")
        return _Type(np.dtype("O", metadata={"vlen": str if kind == "str" else kind}),
                     size, vlen=kind), 8 + blen
    names = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference", 10: "array"}
    raise NotImplementedError(f"HDF5 {names.get(cls, f'class {cls}')} datatype")


def _fixed_point(size: int, signed: bool) -> bytes:
    return struct.pack("<B3BI", 0x10, 0x08 if signed else 0, 0, 0, size) \
        + struct.pack("<HH", 0, 8 * size)


def _encode_type(dt) -> bytes:
    """The version 1 datatype message of a numpy dtype, as h5py writes it."""
    if dt is str:
        return struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 16) + _fixed_point(1, False)
    dt = np.dtype(dt)
    base = check_vlen_dtype(dt)
    if base is not None:
        if base is str:
            return _encode_type(str)
        return struct.pack("<B3BI", 0x19, 0, 0, 0, 16) + _encode_type(base)
    if dt.byteorder == ">":
        raise NotImplementedError("HDF5 big-endian datatype")
    if dt.kind == "b":
        return (struct.pack("<B3BI", 0x18, 2, 0, 0, 1) + _fixed_point(1, True)
                + b"FALSE\x00\x00\x00TRUE\x00\x00\x00\x00" + b"\x00\x01")
    if dt.kind in "iu":
        return _fixed_point(dt.itemsize, dt.kind == "i")
    if dt.kind == "f":
        sign, eloc, esize, msize, bias = {
            2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023),
        }[dt.itemsize]
        return struct.pack("<B3BI", 0x11, 0x20, sign, 0, dt.itemsize) + struct.pack(
            "<HHBBBBI", 0, 8 * dt.itemsize, eloc, esize, 0, msize, bias)
    if dt.kind == "S":
        return struct.pack("<B3BI", 0x13, 0x01, 0, 0, max(dt.itemsize, 1))
    if dt.kind == "V" and dt.names:
        out = struct.pack("<BHBI", 0x16, len(dt.names), 0, dt.itemsize)
        for name in dt.names:
            mdt, moff = dt.fields[name][:2]
            if mdt.shape or check_vlen_dtype(mdt) is not None:
                raise NotImplementedError(
                    f"HDF5 compound member {name!r} of dtype {mdt}")
            nb = name.encode() + b"\x00"
            out += nb + b"\x00" * (_pad8(len(nb)) - len(nb))
            out += struct.pack("<IB3xI4x4I", moff, 0, 0, 0, 0, 0, 0)
            out += _encode_type(mdt)
        return out
    raise TypeError(f"No HDF5 datatype for numpy dtype {dt}")


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _unshuffle(data: bytes, itemsize: int) -> bytes:
    if itemsize <= 1:
        return data
    n = len(data) // itemsize
    head = np.frombuffer(data, np.uint8, n * itemsize).reshape(itemsize, n)
    return head.T.tobytes() + data[n * itemsize:]


_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf",
                 32001: "blosc", 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}


class _Message:
    __slots__ = ("type", "flags", "off", "size")

    def __init__(self, mtype, flags, off, size):
        self.type, self.flags, self.off, self.size = mtype, flags, off, size


class _FileReader:
    """The open file: its bytes, its superblock, and the object parsers."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        size = os.fstat(self._fh.fileno()).st_size
        if size == 0:
            self._fh.close()
            raise OSError(f"{path} is empty, not an HDF5 file")
        self.mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._heaps: Dict[int, Dict[int, Tuple[int, int]]] = {}
        base = 0
        while base < size and self.mm[base:base + 8] != _SIGNATURE:
            base = 512 if base == 0 else base * 2
        if base >= size:
            self.close()
            raise OSError(f"{path} is not an HDF5 file (no superblock signature)")
        mm = self.mm
        version = mm[base + 8]
        if version in (0, 1):
            so, sl = mm[base + 13], mm[base + 14]
            self._check_sizes(so, sl)
            p = base + 24 + (4 if version == 1 else 0)
            self.base = struct.unpack_from("<Q", mm, p)[0]
            root_entry = p + 32
            self.root_addr = struct.unpack_from("<Q", mm, root_entry + 8)[0]
        elif version in (2, 3):
            so, sl = mm[base + 9], mm[base + 10]
            self._check_sizes(so, sl)
            self.base, ext, _eof, self.root_addr = struct.unpack_from("<4Q", mm, base + 12)
            if ext != UNDEF:
                self._check_superblock_extension(ext)
        else:
            self.close()
            raise NotImplementedError(f"HDF5 superblock version {version}")

    def _check_sizes(self, so, sl):
        if so != 8 or sl != 8:
            self.close()
            raise NotImplementedError(f"HDF5 {so}-byte offsets / {sl}-byte lengths")

    def _check_superblock_extension(self, addr):
        for m in self.messages(addr):
            if m.type == 0x000F:
                raise NotImplementedError("HDF5 shared object header messages")

    def close(self):
        if getattr(self, "mm", None) is not None:
            self.mm.close()
            self.mm = None
        self._fh.close()

    # -- object headers ----------------------------------------------------

    def messages(self, addr: int) -> List[_Message]:
        mm = self.mm
        a = self.base + addr
        out: List[_Message] = []
        if mm[a:a + 4] == b"OHDR":
            if mm[a + 4] != 2:
                raise NotImplementedError(f"HDF5 object header version {mm[a + 4]}")
            flags = mm[a + 5]
            p = a + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            nb = 1 << (flags & 3)
            csize = int.from_bytes(mm[p:p + nb], "little")
            p += nb
            blocks = [(p, csize)]
            hsize = 4 + (2 if flags & 0x04 else 0)
            while blocks:
                start, length = blocks.pop(0)
                q, end = start, start + length
                while q + hsize <= end:
                    mtype = mm[q]
                    msize = struct.unpack_from("<H", mm, q + 1)[0]
                    mflags = mm[q + 3]
                    q += hsize
                    out.append(_Message(mtype, mflags, q, msize))
                    if mtype == 0x10:
                        caddr, clen = struct.unpack_from("<QQ", mm, q)
                        c = self.base + caddr
                        if mm[c:c + 4] != b"OCHK":
                            raise OSError(f"{self.path}: bad continuation block at {caddr}")
                        blocks.append((c + 4, clen - 8))
                    q += msize
            return [m for m in out if m.type not in (0, 0x10)]
        if mm[a] != 1:
            raise NotImplementedError(f"HDF5 object header version {mm[a]}")
        nmsgs, _ref, hsize = struct.unpack_from("<HII", mm, a + 2)
        blocks = [(a + 16, hsize)]
        count = 0
        while blocks and count < nmsgs:
            start, length = blocks.pop(0)
            q, end = start, start + length
            while q + 8 <= end and count < nmsgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", mm, q)
                q += 8
                out.append(_Message(mtype, mflags, q, msize))
                count += 1
                if mtype == 0x10:
                    caddr, clen = struct.unpack_from("<QQ", mm, q)
                    blocks.append((self.base + caddr, clen))
                q += msize
        return [m for m in out if m.type not in (0, 0x10)]

    def obj(self, addr: int, name: str):
        msgs = self.messages(addr)
        for m in msgs:
            if m.flags & 0x02:
                raise NotImplementedError("HDF5 shared object header messages")
        types = {m.type for m in msgs}
        if 0x0008 in types:
            return Dataset(self, addr, name, msgs)
        if 0x0003 in types:
            raise NotImplementedError(f"HDF5 committed datatype {name!r}")
        return Group(self, addr, name, msgs)

    # -- groups --------------------------------------------------------------

    def links(self, msgs: List[_Message]) -> Dict[str, int]:
        mm = self.mm
        links: Dict[str, int] = {}
        for m in msgs:
            if m.type == 0x0011:
                btree, heap = struct.unpack_from("<QQ", mm, m.off)
                self._stab_links(btree, heap, links)
            elif m.type == 0x0002:
                flags = mm[m.off + 1]
                p = m.off + 2 + (8 if flags & 1 else 0)
                if struct.unpack_from("<Q", mm, p)[0] != UNDEF:
                    raise NotImplementedError("HDF5 dense link storage (fractal heap)")
            elif m.type == 0x0006:
                name, addr = self._link(m)
                links[name] = addr
        return links

    def _link(self, m: _Message) -> Tuple[str, int]:
        mm = self.mm
        flags = mm[m.off + 1]
        p = m.off + 2
        ltype = 0
        if flags & 0x08:
            ltype = mm[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        nb = 1 << (flags & 3)
        nlen = int.from_bytes(mm[p:p + nb], "little")
        p += nb
        name = mm[p:p + nlen].decode()
        p += nlen
        if ltype == 1:
            raise NotImplementedError(f"HDF5 soft link {name!r}")
        if ltype != 0:
            raise NotImplementedError(f"HDF5 external link {name!r}")
        return name, struct.unpack_from("<Q", mm, p)[0]

    def _stab_links(self, btree: int, heap: int, links: Dict[str, int]):
        mm = self.mm
        h = self.base + heap
        if mm[h:h + 4] != b"HEAP":
            raise OSError(f"{self.path}: bad local heap at {heap}")
        data = self.base + struct.unpack_from("<Q", mm, h + 24)[0]

        def name_at(off):
            end = mm.find(b"\x00", data + off)
            return mm[data + off:end].decode()

        def walk(node):
            n = self.base + node
            sig = mm[n:n + 4]
            if sig == b"SNOD":
                count = struct.unpack_from("<H", mm, n + 6)[0]
                for i in range(count):
                    e = n + 8 + 40 * i
                    noff, oaddr, cache = struct.unpack_from("<QQI", mm, e)
                    if cache == 2:
                        raise NotImplementedError(f"HDF5 soft link {name_at(noff)!r}")
                    links[name_at(noff)] = oaddr
                return
            if sig != b"TREE" or mm[n + 4] != 0:
                raise OSError(f"{self.path}: bad group B-tree node at {node}")
            used = struct.unpack_from("<H", mm, n + 6)[0]
            for i in range(used):
                walk(struct.unpack_from("<Q", mm, n + 24 + 8 + 16 * i)[0])

        walk(btree)

    # -- attributes ------------------------------------------------------------

    def attributes(self, msgs: List[_Message]) -> "Attributes":
        """An object's attributes, each decoded when it is first read: an
        attribute nobody asks for is never decoded, so its type cannot
        refuse the file."""
        mm = self.mm
        out: Dict[str, Any] = {}
        dense = False
        for m in msgs:
            if m.type == 0x0015:
                flags = mm[m.off + 1]
                p = m.off + 2 + (2 if flags & 1 else 0)
                dense = dense or struct.unpack_from("<Q", mm, p)[0] != UNDEF
            elif m.type == 0x000C:
                out[self._attribute_name(m.off)] = _Lazy(
                    lambda off=m.off: self._attribute(off)[1])
        return Attributes(out, writable=False, dense=dense)

    def _attribute_name(self, off: int) -> str:
        mm = self.mm
        version = mm[off]
        nsize = struct.unpack_from("<H", mm, off + 2)[0]
        p = off + 8 + (1 if version == 3 else 0)
        return bytes(mm[p:p + nsize]).rstrip(b"\x00").decode()

    def _attribute(self, off: int):
        mm = self.mm
        version, flags = mm[off], mm[off + 1]
        nsize, tsize, ssize = struct.unpack_from("<HHH", mm, off + 2)
        p = off + 8
        if version == 1:
            pad = _pad8
        elif version in (2, 3):
            if flags & 3:
                raise NotImplementedError("HDF5 shared attribute datatype or dataspace")
            pad = int
            p += 1 if version == 3 else 0
        else:
            raise NotImplementedError(f"HDF5 attribute message version {version}")
        name = mm[p:p + nsize].rstrip(b"\x00").decode()
        p += pad(nsize)
        htype, _ = _decode_type(mm, p)
        p += pad(tsize)
        shape = self._dataspace(p)
        p += pad(ssize)
        n = int(np.prod(shape)) if shape is not None else 0
        raw = mm[p:p + n * htype.size]
        arr = self._convert(raw, htype, shape if shape is not None else (0,))
        if shape == ():
            value = arr[()]
            if htype.vlen == "str" and isinstance(value, bytes):
                value = value.decode("utf-8")
            return name, value
        if htype.vlen == "str":
            arr = np.array([v.decode("utf-8") for v in arr.ravel()], dtype=object).reshape(arr.shape)
        return name, arr

    # -- dataspaces, fill values, layouts ---------------------------------------

    def _dataspace(self, off: int, maxshape: bool = False):
        """The shape of a dataspace message (``None`` for a null space);
        with ``maxshape``, the pair (shape, max shape), None for an
        unlimited dimension."""
        mm = self.mm
        version, rank, flags = mm[off], mm[off + 1], mm[off + 2]
        if version == 1:
            p = off + 8
        elif version == 2:
            if mm[off + 3] == 2:
                return (None, None) if maxshape else None
            p = off + 4
        else:
            raise NotImplementedError(f"HDF5 dataspace version {version}")
        shape = tuple(struct.unpack_from(f"<{rank}Q", mm, p))
        if not maxshape:
            return shape
        top = shape
        if flags & 1:
            top = tuple(None if d == UNDEF else d
                        for d in struct.unpack_from(f"<{rank}Q", mm, p + 8 * rank))
        return shape, top

    def global_object(self, coll: int, index: int) -> bytes:
        objs = self._heaps.get(coll)
        mm = self.mm
        if objs is None:
            c = self.base + coll
            if mm[c:c + 4] != b"GCOL":
                raise OSError(f"{self.path}: bad global heap collection at {coll}")
            size = struct.unpack_from("<Q", mm, c + 8)[0]
            objs = {}
            p, end = c + 16, c + size
            while p + 16 <= end:
                idx = struct.unpack_from("<H", mm, p)[0]
                osize = struct.unpack_from("<Q", mm, p + 8)[0]
                if idx == 0:  # free space, its size counting its own header
                    if osize < 16:
                        break
                    p += osize
                    continue
                objs[idx] = (p + 16, osize)
                p += 16 + _pad8(osize)
            self._heaps[coll] = objs
        start, size = objs[index]
        return mm[start:start + size]

    def _convert(self, raw, htype: _Type, shape) -> np.ndarray:
        """Bytes of ``prod(shape)`` elements to the array h5py returns."""
        if htype.vlen is None:
            return np.frombuffer(raw, htype.dtype).reshape(shape).copy()
        recs = np.frombuffer(raw, np.dtype([("n", "<u4"), ("addr", "<u8"), ("idx", "<u4")]))
        out = np.empty(len(recs), dtype=htype.dtype)
        for i, (n, addr, idx) in enumerate(recs.tolist()):
            data = self.global_object(addr, idx) if n else b""
            if htype.vlen == "str":
                out[i] = data[:n]
            else:
                out[i] = np.frombuffer(data, htype.vlen, n).copy()
        return out.reshape(shape)


class _Lazy:
    """An attribute value still to be decoded."""

    __slots__ = ("decode",)

    def __init__(self, decode):
        self.decode = decode


class Attributes:
    """An object's attributes (h5py's ``AttributeManager``): read from the
    file, or gathered to be written when the file closes.

    An object whose attributes the file keeps in dense storage (a fractal
    heap) answers only for the ones it holds in its header; asking for any
    other, or for the whole list, raises ``NotImplementedError``.
    """

    def __init__(self, values: Dict[str, Any], writable: bool, dense: bool = False):
        self._values = values
        self._writable = writable
        self._dense = dense

    def _check_listable(self):
        if self._dense:
            raise NotImplementedError("HDF5 dense attribute storage (fractal heap)")

    def __getitem__(self, key):
        if key not in self._values:
            self._check_listable()
        value = self._values[key]
        if isinstance(value, _Lazy):
            value = self._values[key] = value.decode()
        return value

    def __setitem__(self, key, value):
        if not self._writable:
            raise OSError("File opened read-only")
        self._values[key] = value

    def __contains__(self, key):
        if key not in self._values:
            self._check_listable()
            return False
        return True

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        self._check_listable()
        return len(self._values)

    def keys(self):
        self._check_listable()
        return self._values.keys()

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def get(self, key, default=None):
        return self[key] if key in self else default


class Group:
    """A group of a file opened for reading."""

    def __init__(self, reader: _FileReader, addr: int, name: str, msgs):
        self._r = reader
        self.name = name
        self._msgs = msgs
        self._links = None
        self._attrs = None

    def _members(self) -> Dict[str, int]:
        if self._links is None:
            self._links = self._r.links(self._msgs)
        return self._links

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            self._attrs = self._r.attributes(self._msgs)
        return self._attrs

    def _child(self, key: str):
        addr = self._members()[key]
        prefix = self.name.rstrip("/")
        return self._r.obj(addr, f"{prefix}/{key}")

    def __getitem__(self, path: str):
        node = self
        parts = [p for p in str(path).split("/") if p]
        for part in parts:
            if not isinstance(node, Group) or part not in node._members():
                raise KeyError(f"Unable to open object {path!r} (not found)")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self) -> List[str]:
        return sorted(self._members())

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._members())

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def visititems(self, fn):
        """Call ``fn(name, obj)`` for every object below, names relative to
        this group, parents before children (h5py's order)."""
        def walk(group, prefix):
            for k in group.keys():
                obj = group[k]
                rel = f"{prefix}{k}"
                res = fn(rel, obj)
                if res is not None:
                    return res
                if isinstance(obj, Group):
                    res = walk(obj, rel + "/")
                    if res is not None:
                        return res
            return None
        return walk(self, "")


class Dataset:
    """A dataset of a file opened for reading."""

    def __init__(self, reader: _FileReader, addr: int, name: str, msgs):
        self._r = reader
        self.name = name
        self._msgs = msgs
        self._attrs = None
        self._chunks_sorted = None
        mm = reader.mm
        self.fillvalue = None
        self._filters: List[Tuple[int, List[int]]] = []
        layout = None
        shape: Optional[Tuple[int, ...]] = ()
        self.maxshape: Optional[Tuple[Optional[int], ...]] = ()
        for m in msgs:
            if m.type == 0x0001:
                shape, self.maxshape = reader._dataspace(m.off, maxshape=True)
            elif m.type == 0x0003:
                self._type, _ = _decode_type(mm, m.off)
            elif m.type == 0x0008:
                layout = m
            elif m.type == 0x000B:
                self._filters = self._filter_pipeline(m.off)
            elif m.type == 0x0005:
                self.fillvalue = self._fill(m.off)
            elif m.type == 0x0004 and self.fillvalue is None:
                n = struct.unpack_from("<I", mm, m.off)[0]
                self.fillvalue = bytes(mm[m.off + 4:m.off + 4 + n]) if n else None
            elif m.type == 0x0007:
                raise NotImplementedError("HDF5 external data files")
        self.shape = shape if shape is not None else ()
        self._null = shape is None
        self._layout(layout.off)

    # -- message parsers -----------------------------------------------------

    def _fill(self, off: int) -> Optional[bytes]:
        mm = self._r.mm
        version = mm[off]
        if version in (1, 2):
            defined = mm[off + 3]
            if version == 2 and not defined:
                return None
            n = struct.unpack_from("<I", mm, off + 4)[0]
            return bytes(mm[off + 8:off + 8 + n]) if n and n != 0xFFFFFFFF else None
        if version == 3:
            flags = mm[off + 1]
            if not flags & 0x20:
                return None
            n = struct.unpack_from("<I", mm, off + 2)[0]
            return bytes(mm[off + 6:off + 6 + n]) if n else None
        raise NotImplementedError(f"HDF5 fill value message version {version}")

    def _filter_pipeline(self, off: int) -> List[Tuple[int, List[int]]]:
        mm = self._r.mm
        version, n = mm[off], mm[off + 1]
        p = off + (8 if version == 1 else 2)
        filters = []
        for _ in range(n):
            fid = struct.unpack_from("<H", mm, p)[0]
            p += 2
            nlen = 0
            if version == 1 or fid >= 256:
                nlen = struct.unpack_from("<H", mm, p)[0]
                p += 2
            _flags, nvals = struct.unpack_from("<HH", mm, p)
            p += 4
            p += _pad8(nlen) if version == 1 else nlen
            vals = list(struct.unpack_from(f"<{nvals}I", mm, p))
            p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (1, 2):
                raise NotImplementedError(
                    f"HDF5 {_FILTER_NAMES.get(fid, f'filter {fid}')} filter")
            filters.append((fid, vals))
        return filters

    def _layout(self, off: int):
        mm = self._r.mm
        version = mm[off]
        self.chunks = None
        self._index = None
        if version in (1, 2):
            ndims, cls = mm[off + 1], mm[off + 2]
            p = off + 8
            addr = UNDEF
            if cls != 0:
                addr = struct.unpack_from("<Q", mm, p)[0]
                p += 8
            dims = struct.unpack_from(f"<{ndims}I", mm, p)
            p += 4 * ndims
            if cls == 0:
                n = struct.unpack_from("<I", mm, p)[0]
                self._compact = bytes(mm[p + 4:p + 4 + n])
            elif cls == 1:
                self._addr = addr
            else:
                self.chunks = tuple(dims[:-1])
                self._index = ("btree1", addr)
            self._cls = cls
            return
        if version not in (3, 4):
            raise NotImplementedError(f"HDF5 data layout version {version}")
        cls = mm[off + 1]
        self._cls = cls
        p = off + 2
        if cls == 0:
            n = struct.unpack_from("<H", mm, p)[0]
            self._compact = bytes(mm[p + 2:p + 2 + n])
        elif cls == 1:
            self._addr = struct.unpack_from("<Q", mm, p)[0]
        elif cls == 2 and version == 3:
            ndims = mm[p]
            addr = struct.unpack_from("<Q", mm, p + 1)[0]
            dims = struct.unpack_from(f"<{ndims}I", mm, p + 9)
            self.chunks = tuple(dims[:-1])
            self._index = ("btree1", addr)
        elif cls == 2:
            flags, ndims, enc = mm[p], mm[p + 1], mm[p + 2]
            p += 3
            dims = [int.from_bytes(mm[p + i * enc:p + (i + 1) * enc], "little")
                    for i in range(ndims)]
            p += ndims * enc
            self.chunks = tuple(dims[:-1])
            itype = mm[p]
            p += 1
            if itype == 1:
                fsize = fmask = None
                if flags & 2:
                    fsize, fmask = struct.unpack_from("<QI", mm, p)
                    p += 12
                self._index = ("single", struct.unpack_from("<Q", mm, p)[0], fsize, fmask)
            elif itype == 2:
                self._index = ("implicit", struct.unpack_from("<Q", mm, p)[0])
            elif itype == 3:
                self._index = ("farray", struct.unpack_from("<Q", mm, p + 1)[0], mm[p])
            elif itype == 4:
                self._index = ("earray", struct.unpack_from("<Q", mm, p + 5)[0])
            elif itype == 5:
                raise NotImplementedError("HDF5 version 2 B-tree chunk index")
            else:
                raise NotImplementedError(f"HDF5 chunk index type {itype}")
        elif cls == 3:
            raise NotImplementedError("HDF5 virtual dataset")
        else:
            raise NotImplementedError(f"HDF5 data layout class {cls}")

    # -- h5py surface ----------------------------------------------------------

    @property
    def dtype(self) -> np.dtype:
        return self._type.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def attrs(self) -> Attributes:
        if self._attrs is None:
            self._attrs = self._r.attributes(self._msgs)
        return self._attrs

    def __getitem__(self, key):
        rows = self._rows(key)
        if rows is not None:
            start, stop = rows
            arr = self._read_rows(start, stop)
            return arr[0] if isinstance(key, (int, np.integer)) else arr
        arr = self.read()
        if key == () or key is Ellipsis:
            return arr[()] if arr.shape == () else arr
        return arr[key]

    def _rows(self, key) -> Optional[Tuple[int, int]]:
        """The rows ``[start, stop)`` of an int or a step-1 slice key, read
        without the rest of the dataset; None for any other key."""
        if not self.shape or self._cls not in (1, 2):
            return None
        n = self.shape[0]
        if isinstance(key, (int, np.integer)):
            i = int(key) + n if int(key) < 0 else int(key)
            if not 0 <= i < n:
                raise IndexError(f"Index ({key}) out of range for (0-{n - 1})")
            return i, i + 1
        if isinstance(key, slice) and key.step in (None, 1):
            start, stop, _ = key.indices(n)
            return start, max(start, stop)
        return None

    def _read_rows(self, start: int, stop: int) -> np.ndarray:
        if self._cls == 2:
            return self._read_chunked(start, stop)
        row = int(np.prod(self.shape[1:])) * self._type.size
        shape = (stop - start,) + tuple(self.shape[1:])
        if self._addr == UNDEF:
            return self._filled(shape)
        a = self._r.base + self._addr
        raw = self._r.mm[a + start * row:a + stop * row]
        return self._r._convert(raw, self._type, shape)

    def _filled(self, shape) -> np.ndarray:
        if self._type.vlen is not None:
            out = np.empty(shape, self.dtype)
            for i in np.ndindex(shape):
                out[i] = "" if self._type.vlen == "str" else np.zeros(0, self._type.vlen)
            return out
        if self.fillvalue is not None:
            return np.full(shape, np.frombuffer(self.fillvalue, self.dtype)[0])
        return np.zeros(shape, self.dtype)

    def read(self) -> np.ndarray:
        """The whole dataset as a numpy array (``ds[()]``)."""
        if self._null:
            raise NotImplementedError("HDF5 null dataspace")
        n = self.size
        if self._cls == 0:
            return self._r._convert(self._compact[:n * self._type.size], self._type, self.shape)
        if self._cls == 1:
            if self._addr == UNDEF or n == 0:
                return self._filled(self.shape)
            a = self._r.base + self._addr
            return self._r._convert(self._r.mm[a:a + n * self._type.size], self._type,
                                    self.shape)
        return self._read_chunked()

    def _read_chunked(self, start: int = 0, stop: Optional[int] = None) -> np.ndarray:
        """Rows ``[start, stop)`` (all by default) of a chunked dataset:
        only the chunks that meet them are inflated."""
        if self._type.vlen is not None:
            raise NotImplementedError("HDF5 chunked variable-length dataset")
        stop = self.shape[0] if stop is None else stop
        out = self._filled((stop - start,) + tuple(self.shape[1:]))
        if out.size == 0:
            return out
        starts, chunks = self._chunk_index()
        c0 = self.chunks[0]
        lo, hi = bisect.bisect_left(starts, start - c0 + 1), bisect.bisect_left(starts, stop)
        for offsets, addr, nbytes, fmask in chunks[lo:hi]:
            raw = bytes(self._r.mm[self._r.base + addr:self._r.base + addr + nbytes])
            for k in range(len(self._filters) - 1, -1, -1):
                if fmask & (1 << k):
                    continue
                fid, _ = self._filters[k]
                raw = zlib.decompress(raw) if fid == 1 else _unshuffle(raw, self._type.size)
            chunk = np.frombuffer(raw, self.dtype, int(np.prod(self.chunks))).reshape(self.chunks)
            r0, r1 = max(offsets[0], start), min(offsets[0] + c0, stop)
            rest = tuple(slice(o, min(o + c, s))
                         for o, c, s in zip(offsets[1:], self.chunks[1:], self.shape[1:]))
            src = (slice(r0 - offsets[0], r1 - offsets[0]),) + tuple(
                slice(0, d.stop - d.start) for d in rest)
            out[(slice(r0 - start, r1 - start),) + rest] = chunk[src]
        return out

    def _chunk_index(self):
        """The stored chunks sorted by their first offset, and those
        offsets; read once a dataset."""
        if self._chunks_sorted is None:
            chunks = sorted(self._chunk_list(), key=lambda c: c[0][0])
            self._chunks_sorted = ([c[0][0] for c in chunks], chunks)
        return self._chunks_sorted

    def _chunk_list(self):
        """(offsets, address, stored size, filter mask) of every stored chunk."""
        mm, base = self._r.mm, self._r.base
        kind, addr = self._index[0], self._index[1]
        if addr == UNDEF:
            return []
        csize = int(np.prod(self.chunks)) * self._type.size
        if kind == "single":
            fsize, fmask = self._index[2], self._index[3]
            return [((0,) * self.ndim, addr, csize if fsize is None else fsize, fmask or 0)]
        grid = [-(-s // c) for s, c in zip(self.shape, self.chunks)]
        if kind == "implicit":
            return [(tuple(i * c for i, c in zip(idx, self.chunks)),
                     addr + k * csize, csize, 0)
                    for k, idx in enumerate(np.ndindex(*grid))]
        if kind == "farray":
            return self._farray_chunks(addr, grid, csize)
        if kind == "earray":
            return self._earray_chunks(addr, csize)
        rank = self.ndim
        ksize = 8 + 8 * (rank + 1)
        out = []

        def walk(node):
            n = base + node
            if mm[n:n + 4] != b"TREE" or mm[n + 4] != 1:
                raise OSError(f"{self._r.path}: bad chunk B-tree node at {node}")
            level = mm[n + 5]
            used = struct.unpack_from("<H", mm, n + 6)[0]
            p = n + 24
            for _ in range(used):
                size, fmask = struct.unpack_from("<II", mm, p)
                offs = struct.unpack_from(f"<{rank}Q", mm, p + 8)
                child = struct.unpack_from("<Q", mm, p + ksize)[0]
                if level:
                    walk(child)
                else:
                    out.append((offs, child, size, fmask))
                p += ksize + 8

        walk(addr)
        return out

    def _farray_chunks(self, addr, grid, csize):
        mm, base = self._r.mm, self._r.base
        h = base + addr
        if mm[h:h + 4] != b"FAHD":
            raise OSError(f"{self._r.path}: bad fixed-array header at {addr}")
        ctype, esize, page_bits = mm[h + 5], mm[h + 6], mm[h + 7]
        nelem = struct.unpack_from("<Q", mm, h + 8)[0]
        dblock = struct.unpack_from("<Q", mm, h + 16)[0]
        d = base + dblock
        if mm[d:d + 4] != b"FADB":
            raise OSError(f"{self._r.path}: bad fixed-array data block at {dblock}")
        p = d + 6 + 8  # signature, version, client id, header address
        if nelem > (1 << page_bits):
            raise NotImplementedError("HDF5 paged fixed-array chunk index")
        filtered = ctype == 1
        out = []
        for k, idx in enumerate(np.ndindex(*grid)):
            if k >= nelem:
                break
            e = p + k * esize
            caddr = struct.unpack_from("<Q", mm, e)[0]
            size, fmask = csize, 0
            if filtered:
                nb = esize - 12
                size = int.from_bytes(mm[e + 8:e + 8 + nb], "little")
                fmask = struct.unpack_from("<I", mm, e + 8 + nb)[0]
            if caddr != UNDEF:
                out.append((tuple(i * c for i, c in zip(idx, self.chunks)), caddr, size, fmask))
        return out

    def _earray_chunks(self, addr, csize):
        """The chunks of an extensible-array index (one unlimited
        dimension, the first): the index block's own elements, then the
        data blocks of each super block, directly from the index block or
        through a secondary block."""
        mm, base = self._r.mm, self._r.base
        unlimited = [i for i, d in enumerate(self.maxshape) if d is None]
        if unlimited != [0]:
            raise NotImplementedError(
                "HDF5 extensible-array chunk index over a dimension other than the first")

        def block(a, sig):
            if mm[base + a:base + a + 4] != sig:
                raise OSError(f"{self._r.path}: bad {sig.decode()} block at {a}")
            return base + a

        h = block(addr, b"EAHD")
        ctype, esize, max_bits, iblk_elmts, dblk_min, sblk_min, page_bits = mm[h + 5:h + 12]
        n_set = struct.unpack_from("<Q", mm, h + 12 + 32)[0]
        iblock = struct.unpack_from("<Q", mm, h + 12 + 48)[0]
        if iblock == UNDEF:
            return []
        log2 = lambda x: x.bit_length() - 1  # noqa: E731
        n_sblks = 1 + max_bits - log2(dblk_min)
        ib_sblks, n_dblk_addrs = 2 * log2(sblk_min), 2 * (sblk_min - 1)
        off_bytes = (max_bits + 7) // 8
        p = block(iblock, b"EAIB") + 14
        elems = [p + k * esize for k in range(iblk_elmts)]
        p += iblk_elmts * esize
        dblk_addrs = struct.unpack_from(f"<{n_dblk_addrs}Q", mm, p)
        sblk_addrs = struct.unpack_from(f"<{n_sblks - ib_sblks}Q", mm, p + 8 * n_dblk_addrs)
        used = 0
        for u in range(n_sblks):
            if len(elems) >= n_set:
                break
            n_dblks, n = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
            if n > 1 << page_bits:
                raise NotImplementedError("HDF5 paged extensible-array data block")
            if u < ib_sblks:
                addrs = dblk_addrs[used:used + n_dblks]
                used += n_dblks
            elif sblk_addrs[u - ib_sblks] == UNDEF:
                addrs = (UNDEF,) * n_dblks
            else:
                q = block(sblk_addrs[u - ib_sblks], b"EASB") + 14 + off_bytes
                addrs = struct.unpack_from(f"<{n_dblks}Q", mm, q)
            for a in addrs:
                if a == UNDEF:
                    elems += [None] * n
                else:
                    q = block(a, b"EADB") + 14 + off_bytes
                    elems += [q + k * esize for k in range(n)]
        grid = [-(-m // c) for m, c in zip(self.maxshape[1:], self.chunks[1:])]
        out = []
        for k, e in enumerate(elems[:n_set]):
            if e is None:
                continue
            caddr = struct.unpack_from("<Q", mm, e)[0]
            if caddr == UNDEF:
                continue
            size, fmask = csize, 0
            if ctype == 1:
                nb = esize - 12
                size = int.from_bytes(mm[e + 8:e + 8 + nb], "little")
                fmask = struct.unpack_from("<I", mm, e + 8 + nb)[0]
            idx = np.unravel_index(k, [n_set] + grid) if grid else (k,)
            offs = tuple(int(i) * c for i, c in zip(idx, self.chunks))
            if all(o < s for o, s in zip(offs, self.shape)):
                out.append((offs, caddr, size, fmask))
        return out


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _as_array(value) -> np.ndarray:
    """An attribute or dataset value as a numpy array, as h5py converts it."""
    if isinstance(value, np.ndarray):
        return value
    if isinstance(value, str):
        arr = np.empty((), dtype=string_dtype())
        arr[()] = value
        return arr
    if isinstance(value, bytes) and not isinstance(value, np.bytes_):
        value = np.bytes_(value)
    return np.asarray(value)


def _dataspace_msg(shape: Tuple[int, ...], maxshape=None) -> bytes:
    rank = len(shape)
    out = struct.pack("<BBBB4x", 1, rank, 1 if rank else 0, 0)
    out += struct.pack(f"<{rank}Q", *shape)
    if rank:
        out += struct.pack(f"<{rank}Q", *(maxshape or shape))
    return out


def _msg(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + b"\x00" * (_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


class _Writer:
    """Appends to the file in order and hands back each block's address."""

    def __init__(self, path: str):
        self.fh = open(path, "wb")
        self.fh.write(b"\x00" * 96)  # the superblock, written last
        self.pos = 96

    def put(self, data: bytes, align: int = 8) -> int:
        pad = (-self.pos) % align
        if pad:
            self.fh.write(b"\x00" * pad)
            self.pos += pad
        addr = self.pos
        self.fh.write(data)
        self.pos += len(data)
        return addr

    def global_heap(self, objects: List[bytes]) -> List[Tuple[int, int]]:
        """Write objects into global heap collections; returns each one's
        (collection address, index)."""
        ids: List[Tuple[int, int]] = []
        i = 0
        while i < len(objects):
            body = bytearray()
            idx = 0
            while i < len(objects) and idx < 0xFFFF and (
                    idx == 0 or len(body) + 16 + len(objects[i]) <= _MAX_COLLECTION_PAYLOAD):
                obj = objects[i]
                idx += 1
                body += struct.pack("<HH4xQ", idx, 1, len(obj))
                body += obj + b"\x00" * (_pad8(len(obj)) - len(obj))
                i += 1
            size = max(_MIN_COLLECTION, 16 + len(body) + 16)
            free = size - 16 - len(body)
            body += struct.pack("<HH4xQ", 0, 0, free) + b"\x00" * (free - 16)
            addr = self.put(b"GCOL" + struct.pack("<B3xQ", 1, size) + bytes(body))
            ids.extend((addr, k) for k in range(1, idx + 1))
        return ids

    def raw(self, arr: np.ndarray) -> bytes:
        """The bytes of an array as stored: vlen elements become records."""
        base = check_vlen_dtype(arr.dtype)
        if base is None:
            dt = arr.dtype
            if dt.kind == "S" and dt.itemsize == 0:
                arr = arr.astype("S1")
            return np.ascontiguousarray(arr).tobytes()
        flat = arr.ravel()
        objs, lens = [], []
        for v in flat:
            if base is str:
                b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
                lens.append(len(b))
            else:
                a = np.ascontiguousarray(v, dtype=base)
                b = a.tobytes()
                lens.append(a.size)
            objs.append(b)
        keep = [k for k, n in enumerate(lens) if n]
        ids = self.global_heap([objs[k] for k in keep])
        recs = np.zeros(len(flat), [("n", "<u4"), ("addr", "<u8"), ("idx", "<u4")])
        recs["n"] = lens
        for k, (addr, idx) in zip(keep, ids):
            recs["addr"][k] = addr
            recs["idx"][k] = idx
        return recs.tobytes()


class _WNode:
    def __init__(self, writer: "_Writer"):
        self._w = writer
        self.attrs = Attributes({}, writable=True)

    def _attr_msgs(self) -> List[bytes]:
        out = []
        for name, value in self.attrs.items():
            arr = _as_array(value)
            tmsg = _encode_type(arr.dtype)
            smsg = _dataspace_msg(arr.shape)
            data = self._w.raw(arr)
            nb = name.encode() + b"\x00"
            body = struct.pack("<BxHHH", 1, len(nb), len(tmsg), len(smsg))
            for part in (nb, tmsg, smsg):
                body += part + b"\x00" * (_pad8(len(part)) - len(part))
            out.append(_msg(0x000C, body + data))
        return out

    def _header(self, msgs: List[bytes]) -> int:
        body = b"".join(msgs)
        return self._w.put(struct.pack("<BxHII4x", 1, len(msgs), 1, len(body)) + body)


class _WDataset(_WNode):
    def __init__(self, writer, arr: np.ndarray, compression, compression_opts):
        super().__init__(writer)
        self.shape = arr.shape
        self._type = _encode_type(arr.dtype)
        n = arr.size
        if compression is None:
            data = writer.raw(arr) if n else b""
            addr = writer.put(data) if n else UNDEF
            self._layout = struct.pack("<BBQQ", 3, 1, addr, len(data))
            self._filters = None
            self._alloc = 2
            self._maxshape = arr.shape
            return
        if compression != "gzip":
            raise NotImplementedError(f"HDF5 {compression} filter")
        if not arr.shape:
            raise TypeError("Scalar datasets don't support chunk/filter options")
        if check_vlen_dtype(arr.dtype) is not None:
            raise NotImplementedError("HDF5 chunked variable-length dataset")
        level = 4 if compression_opts is None else int(compression_opts)
        if arr.nbytes >= 1 << 32:  # a chunk's size is a 32-bit field
            raise NotImplementedError(
                f"HDF5 chunk of {arr.nbytes} bytes (one chunk a dataset, 4 GiB at most)")
        chunks = tuple(max(d, 1) for d in arr.shape)
        rank = len(chunks)
        itemsize = arr.dtype.itemsize
        btree = UNDEF
        if n:
            comp = zlib.compress(writer.raw(arr), level)
            caddr = writer.put(comp)
            key = struct.Struct(f"<II{rank + 1}Q")
            node = bytearray(b"TREE" + struct.pack("<BBHQQ", 1, 0, 1, UNDEF, UNDEF))
            node += key.pack(len(comp), 0, *([0] * (rank + 1)))
            node += struct.pack("<Q", caddr)
            node += key.pack(0, 0, *chunks, 0)
            full = 24 + 2 * _CHUNK_NODE_K * 8 + (2 * _CHUNK_NODE_K + 1) * key.size
            node += b"\x00" * (full - len(node))
            btree = writer.put(bytes(node))
        self._layout = struct.pack(f"<BBBQ{rank + 1}I", 3, 2, rank + 1, btree,
                                   *chunks, itemsize)
        self._filters = struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1) + b"deflate\x00" \
            + struct.pack("<I4x", level)
        self._alloc = 3
        self._maxshape = arr.shape

    def _close(self) -> int:
        msgs = [
            _msg(0x0001, _dataspace_msg(self.shape, self._maxshape)),
            _msg(0x0003, self._type, flags=1),
            _msg(0x0005, struct.pack("<BBBB", 2, self._alloc, 2, 1) + struct.pack("<I", 0),
                 flags=1),
            _msg(0x0008, self._layout),
        ]
        if self._filters is not None:
            msgs.append(_msg(0x000B, self._filters, flags=1))
        return self._header(msgs + self._attr_msgs())


class _WGroup(_WNode):
    """A group of a file opened for writing."""

    def __init__(self, writer, name: str):
        super().__init__(writer)
        self.name = name
        self._children: Dict[str, _WNode] = {}

    def _parent_of(self, path: str) -> Tuple["_WGroup", str]:
        parts = [p for p in str(path).split("/") if p]
        node = self
        for part in parts[:-1]:
            child = node._children.get(part)
            if child is None:
                child = node.create_group(part)
            if not isinstance(child, _WGroup):
                raise TypeError(f"{part!r} is a dataset, not a group")
            node = child
        if parts[-1] in node._children:
            raise ValueError(f"Unable to create {path!r} (name already exists)")
        return node, parts[-1]

    def create_group(self, name: str) -> "_WGroup":
        parent, leaf = self._parent_of(name)
        grp = _WGroup(self._w, f"{parent.name.rstrip('/')}/{leaf}")
        parent._children[leaf] = grp
        return grp

    def create_dataset(self, name: str, data, compression=None,
                       compression_opts=None) -> _WDataset:
        """Write ``data`` as a dataset now (its header is written when the
        file closes). An object array of ``vlen_dtype(np.uint8)`` holds
        variable-length sequences; ``compression="gzip"`` stores it as one
        deflated chunk at level ``compression_opts`` (4 by default)."""
        arr = _as_array(data)
        if arr.dtype.kind == "U":
            raise TypeError("No conversion path for dtype: " + repr(arr.dtype))
        parent, leaf = self._parent_of(name)
        ds = _WDataset(self._w, arr, compression, compression_opts)
        ds.name = f"{parent.name.rstrip('/')}/{leaf}"
        parent._children[leaf] = ds
        return ds

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in str(path).split("/") if p]:
            node = node._children[part]
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except (KeyError, AttributeError):
            return False
        return True

    def keys(self) -> List[str]:
        return sorted(self._children)

    def _close(self) -> Tuple[int, int, int]:
        """Write the children, then this group; returns its header, B-tree
        and local heap addresses."""
        names = sorted(self._children, key=lambda s: s.encode())
        entries = []
        for name in names:
            child = self._children[name]
            if isinstance(child, _WGroup):
                addr, bt, hp = child._close()
                entries.append((name, addr, 1, struct.pack("<QQ", bt, hp)))
            else:
                entries.append((name, child._close(), 0, b"\x00" * 16))
        heap = bytearray(b"\x00" * 8)  # offset 0: the empty name
        name_off = {}
        for name in names:
            name_off[name] = len(heap)
            nb = name.encode() + b"\x00"
            heap += nb + b"\x00" * (_pad8(len(nb)) - len(nb))
        leaf_cap = 2 * _LEAF_K
        leaves = [entries[i:i + leaf_cap] for i in range(0, len(entries), leaf_cap)] or [[]]
        if len(leaves) > 2 * _GROUP_NODE_K:
            raise NotImplementedError(
                f"HDF5 group of {len(entries)} members (more than one B-tree node)")
        snods = []
        for leaf in leaves:
            node = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(leaf)))
            for name, addr, cache, scratch in leaf:
                node += struct.pack("<QQI4x", name_off[name], addr, cache) + scratch
            node += b"\x00" * (8 + 40 * leaf_cap - len(node))
            snods.append(self._w.put(bytes(node)))
        # The data segment ends in one free block, as the HDF5 library leaves
        # it: (next free block = 1, meaning none; its size).
        used = len(heap)
        heap += b"\x00" * (max(88, _pad8(used + 16)) - used)
        struct.pack_into("<QQ", heap, used, 1, len(heap) - used)
        data_addr = self._w.put(bytes(heap))
        heap_addr = self._w.put(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), used,
                                                       data_addr))
        node = bytearray(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(leaves), UNDEF, UNDEF))
        node += struct.pack("<Q", 0)
        for leaf, snod in zip(leaves, snods):
            last = name_off[leaf[-1][0]] if leaf else 0
            node += struct.pack("<QQ", snod, last)
        node += b"\x00" * (24 + (2 * _GROUP_NODE_K + 1) * 8 + 2 * _GROUP_NODE_K * 8 - len(node))
        btree = self._w.put(bytes(node))
        msgs = [_msg(0x0011, struct.pack("<QQ", btree, heap_addr))] + self._attr_msgs()
        return self._header(msgs), btree, heap_addr


class File:
    """An HDF5 file: ``File(path, "r")`` reads, ``File(path, "w")`` writes.

    Reading gives the root ``Group`` (``f["a/b"]``, ``"a" in f``,
    ``f.keys()``, ``f.attrs``). Writing offers ``create_group``,
    ``create_dataset`` and ``attrs``; datasets are written when created and
    the headers, groups and superblock when the file closes.
    """

    def __init__(self, path, mode: str = "r"):
        self.filename = str(path)
        self.mode = mode
        if mode == "r":
            self._reader = _FileReader(self.filename)
            self._root = self._reader.obj(self._reader.root_addr, "/")
            self._writer = None
        elif mode == "w":
            self._reader = None
            self._writer = _Writer(self.filename)
            self._root = _WGroup(self._writer, "/")
        else:
            raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._root, name)

    def __getitem__(self, path):
        return self._root[path]

    def __contains__(self, path):
        return path in self._root

    def __iter__(self):
        return iter(self._root.keys())

    def __len__(self):
        return len(self._root.keys())

    @property
    def attrs(self) -> Attributes:
        return self._root.attrs

    def close(self):
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        if self._writer is not None:
            w, self._writer = self._writer, None
            try:
                root, btree, heap = self._root._close()
                eof = w.pos
                sb = _SIGNATURE + struct.pack(
                    "<BBBBBBBBHHI", 0, 0, 0, 0, 0, 8, 8, 0, _LEAF_K, _GROUP_NODE_K, 0)
                sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                sb += struct.pack("<QQI4xQQ", 0, root, 1, btree, heap)
                w.fh.seek(0)
                w.fh.write(sb)
            finally:
                w.fh.close()
