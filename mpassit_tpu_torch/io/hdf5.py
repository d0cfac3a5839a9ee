"""HDF5 encoder and reader for the subset of the format the port's NetCDF4
files use, in numpy and the standard library (no h5py, no libhdf5).

The structures are those h5py 3.14 / HDF5 1.14 writes for the calls
``io/nc4.NetCDF4File`` makes (File Format Specification version 3.0, the
section named beside each encoder below):

- superblock version 0, offsets and lengths of 8 bytes (files past 4 GiB
  work);
- version-2 object headers (``OHDR``, Jenkins lookup3 checksum) with
  attribute creation order tracked and indexed, one chunk each;
- the root group's links compact in its header (link info, group info and
  link messages) with their creation order, which netCDF-C numbers dims
  and variables by;
- attributes compact in each header (version-1 attribute messages): fixed
  ASCII strings, numeric scalars and arrays, the null dataspace (an empty
  text attribute), and the dimension-scale attributes of the HDF5
  high-level library (``CLASS``, ``NAME``, ``REFERENCE_LIST`` a compound of
  an object reference and a u4, ``DIMENSION_LIST`` a vlen of object
  references in a global heap collection);
- contiguous data, allocated at its first write (a dataset never written,
  as a dimension scale is, stays unallocated and reads as its fill value
  0), or a 1-D chunked dataset with an unlimited maximum and no chunk
  written (the unlimited ``Time`` dimension).

The writer (``open_file(path, "w")``) places each dataset's data where it
is first written, in the order of first writes, and writes it there with
positioned writes (``os.pwrite``), so a writer thread shares no file
offset; the metadata goes after the data and the superblock at offset 0
when the file is closed.

The reader (``open_file(path, "r")``) reads, through ``mmap``, what this
writer writes and the root group of what netCDF-C (4.9, HDF5 1.10-1.14)
and h5py write, as h5py reads it: superblocks 0-3; old-style
(symbol-table) groups and new-style groups with compact or dense links;
compact or dense attributes (fractal heaps, v2 B-trees; huge heap
objects, direct or through the heap's own v2 B-tree), variable-length
strings; compact, contiguous and chunked data under every chunk index
(the v1 B-tree; layout 4's single chunk, implicit, fixed array,
extensible array and v2 B-tree, the indexes of ``libver="latest"``
writers), through the deflate, shuffle, Fletcher32, szip, n-bit,
scale-offset and LZF filters (the last four in ``io/h5filters.py``;
szip and LZF are C++ built with g++ at their first use), integers of
fewer bits than their size as HDF5 converts them, big-endian data as the
dataset's own dtype, chunks never written as the fill value; every
checksum is verified. Anything else raises ``FatalError`` naming it:
shared messages, external or virtual storage, plugin filters other than
LZF (zstd, blosc, bzip2, ...), filtered heap blocks, n-bit on compound or
array types, floating-point types of fewer bits than their size, edge
chunks stored unfiltered, a superblock not at offset 0 (a user block),
offsets not of 8 bytes; groups below the root are not read. Both expose
the small part of h5py's interface that ``NetCDF4File`` calls.
"""

from __future__ import annotations

import bisect
import mmap
import os
import struct
import threading
import zlib

import numpy as np

from ..errors import FatalError
from . import h5filters

MAGIC = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFF_FFFF_FFFF_FFFF
_SB_SIZE = 96
#: h5py's chunk for a 1-D dataset with an unlimited maximum of f4
_UNLIMITED_CHUNK = 1024
_MAX_MESSAGE = 0xFFFF


# ---- Jenkins lookup3 (hashlittle), the checksum of HDF5 metadata ----------

def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & 0xFFFFFFFF


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' ``hashlittle`` (lookup3.c), as H5_checksum_lookup3."""
    m = 0xFFFFFFFF
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & m
    # every 12-byte block but the last is mixed; the last (1 to 12 bytes,
    # zero-padded) goes through the final mix
    blocks = (n - 1) // 12 if n else 0
    words = np.frombuffer(data[:12 * blocks], "<u4").tolist()
    for i in range(0, 3 * blocks, 3):
        a = (a + words[i]) & m
        b = (b + words[i + 1]) & m
        c = (c + words[i + 2]) & m
        # mix(a, b, c)
        for k1, k2, k3 in ((4, 6, 8), (16, 19, 4)):
            a = ((a - c) & m) ^ _rot(c, k1)
            c = (c + b) & m
            b = ((b - a) & m) ^ _rot(a, k2)
            a = (a + c) & m
            c = ((c - b) & m) ^ _rot(b, k3)
            b = (b + a) & m
    tail = data[12 * blocks:]
    if not tail:
        return c
    ta, tb, tc = struct.unpack("<III", tail + bytes(12 - len(tail)))
    a, b, c = (a + ta) & m, (b + tb) & m, (c + tc) & m
    # final(a, b, c)
    c = ((c ^ b) - _rot(b, 14)) & m
    a = ((a ^ c) - _rot(c, 11)) & m
    b = ((b ^ a) - _rot(a, 25)) & m
    c = ((c ^ b) - _rot(b, 16)) & m
    a = ((a ^ c) - _rot(c, 4)) & m
    b = ((b ^ a) - _rot(a, 14)) & m
    c = ((c ^ b) - _rot(b, 24)) & m
    return c


class Empty:
    """The value of an attribute with a null dataspace (h5py's ``Empty``):
    netCDF-C's zero-length text attribute."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


class Dataset:
    """A dataset of the root group, written or read (``name``, ``shape``,
    ``ndim``, ``dtype``, ``attrs`` and ``dims`` as in h5py)."""

    name: str
    shape: tuple
    dtype: np.dtype

    @property
    def ndim(self):
        return len(self.shape)


# ---- encoders (File Format Specification, section IV) ---------------------

def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _fixed_type(dt: np.dtype) -> bytes:
    """Datatype message, class 0 (fixed-point) or 1 (floating-point)."""
    order = 1 if dt.byteorder == ">" else 0
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return (bytes([0x10, order | (8 if dt.kind == "i" else 0), 0, 0])
                + struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize))
    if dt.kind == "f" and dt.itemsize in (4, 8):
        bits, exp_loc, exp_size, mant, bias = (
            (32, 23, 8, 23, 127) if dt.itemsize == 4
            else (64, 52, 11, 52, 1023))
        return (bytes([0x11, 0x20 | order, bits - 1, 0])
                + struct.pack("<IHHBBBBI", dt.itemsize, 0, bits, exp_loc,
                              exp_size, 0, mant, bias))
    raise FatalError(f"HDF5 ENCODER: NO DATATYPE FOR {dt}")


def _string_type(size: int, nullterm: bool = False) -> bytes:
    """Class 3, ASCII, null-padded (h5py's ``S``) or null-terminated (the
    high-level library's dimension-scale strings)."""
    return bytes([0x13, 0 if nullterm else 1, 0, 0]) + struct.pack("<I", size)


def _dtype_msg(dt: np.dtype) -> bytes:
    if dt.kind == "S" and dt.itemsize > 0:
        return _string_type(dt.itemsize)
    return _fixed_type(dt)


_REF_TYPE = bytes([0x17, 0, 0, 0]) + struct.pack("<I", 8)
#: vlen sequence of object references (``DIMENSION_LIST``)
_VLEN_REF_TYPE = bytes([0x19, 0, 0, 0]) + struct.pack("<I", 16) + _REF_TYPE


def _compound_member(name: bytes, offset: int, mtype: bytes) -> bytes:
    return _pad8(name + b"\0") + struct.pack("<IB3xI4x16x", offset, 0, 0) \
        + mtype


#: compound {dataset: object reference, dimension: u4}, itemsize 16
#: (``REFERENCE_LIST``), version 1 members as the high-level library writes
_REFLIST_TYPE = (bytes([0x16, 2, 0, 0]) + struct.pack("<I", 16)
                 + _compound_member(b"dataset", 0, _REF_TYPE)
                 + _compound_member(b"dimension", 8,
                                    _fixed_type(np.dtype("<u4"))))


def _space_msg(shape, maxshape=None) -> bytes:
    """Dataspace message: version 1 (scalar or simple), version 2 for the
    null dataspace (``shape`` None)."""
    if shape is None:
        return bytes([2, 0, 0, 2])
    if not shape:
        return bytes([1, 0, 0, 0, 0, 0, 0, 0])
    maxshape = shape if maxshape is None else maxshape
    return (bytes([1, len(shape), 1, 0, 0, 0, 0, 0])
            + struct.pack(f"<{len(shape)}Q", *shape)
            + struct.pack(f"<{len(shape)}Q",
                          *[UNDEF if m is None else m for m in maxshape]))


def _attr_msg(name: str, dtype: bytes, space: bytes, data: bytes) -> bytes:
    """Attribute message, version 1 (name, datatype and dataspace each
    padded to 8 bytes)."""
    nm = name.encode() + b"\0"
    return (struct.pack("<BBHHH", 1, 0, len(nm), len(dtype), len(space))
            + _pad8(nm) + _pad8(dtype) + _pad8(space) + data)


def _encode_value(value):
    """An attribute value as (datatype, dataspace, data) bytes, the types
    h5py stores for the values ``NetCDF4File`` passes."""
    if isinstance(value, Empty):
        return _dtype_msg(value.dtype), _space_msg(None), b""
    if isinstance(value, bytes) and not isinstance(value, np.bytes_):
        value = np.bytes_(value)
    arr = np.asarray(value)
    if arr.dtype.kind not in "iufS" or (arr.dtype.kind == "S"
                                        and arr.dtype.itemsize == 0):
        raise FatalError("HDF5 ENCODER: ATTRIBUTE VALUE OF TYPE "
                         f"{arr.dtype} IS NOT SUPPORTED")
    return (_dtype_msg(arr.dtype), _space_msg(arr.shape),
            np.ascontiguousarray(arr).tobytes())


class _WAttrs(dict):
    """Attributes of one written object, in creation order; setting an
    existing name deletes and recreates it, as h5py does. Each entry's
    encoding and creation index are kept beside its value."""

    def __init__(self):
        super().__init__()
        self.enc = {}           # name -> (creation index, encoder)
        self.next_crt = 0

    def _put(self, name, value, encoder):
        self.pop(name, None)
        self.enc.pop(name, None)
        dict.__setitem__(self, name, value)
        self.enc[name] = (self.next_crt, encoder)
        self.next_crt += 1

    def __setitem__(self, name, value):
        dtype, space, data = _encode_value(value)
        self._put(name, value,
                  lambda addr, heap: _attr_msg(name, dtype, space, data))


class _DimProxy:
    def __init__(self, ds, axis):
        self.ds, self.axis = ds, axis

    def attach_scale(self, scale):
        self.ds._attach(self.axis, scale)


class _WDataset(Dataset):
    """A dataset being written (see ``_Writer.create_dataset``)."""

    def __init__(self, owner, name, shape, dtype, maxshape):
        self._owner = owner
        self.name = "/" + name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)
        self.chunked = maxshape is not None and tuple(maxshape) != self.shape
        if self.chunked and (len(self.shape) != 1 or maxshape[0] is not None):
            raise FatalError(f"HDF5 ENCODER: {name}: ONLY A 1-D DATASET "
                             "WITH AN UNLIMITED MAXIMUM MAY BE EXTENDIBLE")
        self.addr = None
        self.attrs = _WAttrs()
        self._dim_list = None   # per axis, the attached scales
        self._ref_list = []     # (dataset, axis) attached to this scale

    @property
    def nbytes(self):
        return int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize

    @property
    def dims(self):
        return [_DimProxy(self, i) for i in range(len(self.shape))]

    def resize(self, shape):
        if not self.chunked:
            raise FatalError(f"HDF5 ENCODER: {self.name} IS NOT EXTENDIBLE")
        self.shape = tuple(shape)

    def make_scale(self, dimname: str = ""):
        """H5DSset_scale: ``CLASS`` and ``NAME``, null-terminated."""
        for key, text in (("CLASS", b"DIMENSION_SCALE"),
                          ("NAME", dimname.encode())):
            if key == "NAME" and not text:
                continue
            dtype = _string_type(len(text) + 1, nullterm=True)
            msg = _attr_msg(key, dtype, _space_msg(()), text + b"\0")
            self.attrs._put(key, np.bytes_(text),
                            lambda addr, heap, msg=msg: msg)

    def _attach(self, axis, scale):
        """H5DSattach_scale: ``DIMENSION_LIST`` is created at the first
        attach and updated in place; the scale's ``REFERENCE_LIST`` is
        deleted and recreated with one more entry at each."""
        if self._dim_list is None:
            self._dim_list = [[] for _ in self.shape]
            self.attrs._put("DIMENSION_LIST", None, self._dimlist_msg)
        self._dim_list[axis].append(scale)
        scale._ref_list.append((self, axis))
        scale.attrs._put("REFERENCE_LIST", None, scale._reflist_msg)

    def _dimlist_msg(self, addr, heap):
        data = b"".join(struct.pack("<IQI", len(s), *heap[(self, i)])
                        if s else bytes(16)
                        for i, s in enumerate(self._dim_list))
        return _attr_msg("DIMENSION_LIST", _VLEN_REF_TYPE,
                         _space_msg((len(self.shape),)), data)

    def _reflist_msg(self, addr, heap):
        data = b"".join(struct.pack("<QI4x", addr[ds], axis)
                        for ds, axis in self._ref_list)
        return _attr_msg("REFERENCE_LIST", _REFLIST_TYPE,
                         _space_msg((len(self._ref_list),)), data)

    # -- data --------------------------------------------------------------

    def _region(self, key):
        """(starts, counts) of an h5py-style selection: ``...`` or a tuple
        of unit-step slices, one per axis."""
        if key is Ellipsis or key == ():
            return (0,) * len(self.shape), self.shape
        key = key if isinstance(key, tuple) else (key,)
        if len(key) != len(self.shape) or any(
                not isinstance(k, slice) or k.step not in (None, 1)
                for k in key):
            raise FatalError(f"HDF5 ENCODER: {self.name}: SELECTION {key} "
                             "IS NOT A BLOCK")
        rng = [k.indices(n) for k, n in zip(key, self.shape)]
        return (tuple(r[0] for r in rng),
                tuple(max(r[1] - r[0], 0) for r in rng))

    def __setitem__(self, key, value):
        if self.chunked:
            raise FatalError(f"HDF5 ENCODER: {self.name}: the port's HDF5 "
                             "encoder stores contiguous data only")
        starts, counts = self._region(key)
        a = np.asarray(value)
        if a.dtype != self.dtype:
            a = a.astype(self.dtype)
        a = np.broadcast_to(a, counts)
        if not a.size:
            return
        base = self._owner._alloc(self)
        item = self.dtype.itemsize
        rank = len(self.shape)
        strides = [int(np.prod(self.shape[i + 1:], dtype=np.int64))
                   for i in range(rank)]
        # j: the first axis from which the block is one contiguous run
        j = rank - 1
        while j > 0 and counts[j] == self.shape[j]:
            j -= 1
        for idx in np.ndindex(*counts[:j]):
            off = sum((starts[i] + idx[i]) * strides[i] for i in range(j))
            off += starts[j] * strides[j] if rank else 0
            self._owner._pwrite(np.ascontiguousarray(a[idx]),
                                base + off * item)

    def __getitem__(self, key):
        if key is not Ellipsis and key != ():
            raise FatalError(f"HDF5 ENCODER: {self.name}: ONLY [...] IS "
                             "READ BACK WHILE WRITING")
        if self.addr is None:
            return np.zeros(self.shape, self.dtype)
        raw = os.pread(self._owner._fd, self.nbytes, self.addr)
        return np.frombuffer(raw, self.dtype).reshape(self.shape).copy()


def _oh(messages, phase=None) -> bytes:
    """A version-2 object header of one chunk (IV.A.1.b): ``messages`` are
    (type, flags, creation index, body)."""
    body = b"".join(struct.pack("<BHBH", t, len(m), fl, crt) + m
                    for t, fl, crt, m in messages)
    for t, _, _, m in messages:
        if len(m) > _MAX_MESSAGE:
            raise FatalError(f"HDF5 ENCODER: A HEADER MESSAGE OF TYPE {t} "
                             f"HOLDS {len(m)} BYTES (AT MOST 65535)")
    width = next(w for w in (0, 1, 2, 3) if len(body) < 1 << (8 << w))
    # attribute creation order tracked and indexed (0x0C), phase change
    # values stored (0x10)
    flags = width | 0x0C | (0x10 if phase else 0)
    head = b"OHDR" + bytes([2, flags])
    if phase:
        head += struct.pack("<HH", *phase)
    head += len(body).to_bytes(1 << width, "little")
    out = head + body
    return out + struct.pack("<I", lookup3(out))


def _attr_phase(attrs):
    n = len(attrs)
    return (n, 6) if n > 8 else None


def _attr_messages(attrs, addr, heap):
    info = struct.pack("<BBH3Q", 0, 3, attrs.next_crt, UNDEF, UNDEF, UNDEF)
    msgs = [(0x15, 4, 0, info)]
    for name in attrs:
        crt, enc = attrs.enc[name]
        msgs.append((0x0C, 0, crt, enc(addr, heap)))
    return msgs


def _gcol(objects) -> bytes:
    """A global heap collection (III.E) of ``objects`` (bytes), indices
    from 1, padded to 4096 bytes or more by its free-space object."""
    body = b"".join(struct.pack("<HHIQ", i + 1, 0, 0, len(o)) + _pad8(o)
                    for i, o in enumerate(objects))
    size = 16 + len(body) + 16
    size += -size % 4096
    free = size - 16 - len(body)
    return (b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + body
            + struct.pack("<HHIQ", 0, 0, 0, free) + bytes(free - 16))


class _Writer:
    """The encoder behind ``open_file(path, "w")``."""

    def __init__(self, path, mode):
        flags = os.O_RDWR | os.O_CREAT | os.O_TRUNC
        if mode in ("w-", "x"):
            flags |= os.O_EXCL
        self.path = path
        self._fd = os.open(path, flags, 0o666)
        self._end = _SB_SIZE
        self._lock = threading.Lock()
        self._datasets = {}
        self.attrs = _WAttrs()

    def __contains__(self, name):
        return name in self._datasets

    def __getitem__(self, name):
        return self._datasets[name]

    def create_dataset(self, name, shape, dtype, maxshape=None,
                       track_order=True):
        """A contiguous dataset (``maxshape`` given: a 1-D chunked one with
        an unlimited maximum). Its attributes' creation order is always
        tracked; ``track_order`` is h5py's keyword, taken for the callers
        that also write through h5py."""
        if name in self._datasets:
            raise FatalError(f"HDF5 ENCODER: {name} EXISTS")
        ds = _WDataset(self, name, shape, dtype, maxshape)
        self._datasets[name] = ds
        return ds

    def _alloc(self, ds) -> int:
        with self._lock:
            if ds.addr is None:
                ds.addr = self._end
                self._end += ds.nbytes + (-ds.nbytes % 8)
            return ds.addr

    def _pwrite(self, buf, off):
        mv = memoryview(buf).cast("B")
        while mv:
            n = os.pwrite(self._fd, mv, off)
            mv, off = mv[n:], off + n

    def _headers(self, addr, heap):
        """Every object header, the root group's first, in order."""
        objs = list(self._datasets.values())
        links = []
        for crt, ds in enumerate(objs):
            nm = ds.name[1:].encode()
            wide = len(nm) > 255
            links.append((0x06, 0, 0, bytes([1, 0x04 | wide])
                          + struct.pack("<Q", crt)
                          + len(nm).to_bytes(2 if wide else 1, "little")
                          + nm + struct.pack("<Q", addr[ds])))
        ginfo = (bytes([0, 1]) + struct.pack("<HH", len(objs), 6)
                 if len(objs) > 8 else bytes([0, 0]))
        if len(objs) > _MAX_MESSAGE:
            raise FatalError("HDF5 ENCODER: MORE THAN 65535 DATASETS")
        ainfo, *attrs = _attr_messages(self.attrs, addr, heap)
        root = _oh([(0x02, 0, 0, struct.pack("<BBQ3Q", 0, 3, len(objs),
                                              UNDEF, UNDEF, UNDEF)),
                    (0x0A, 1, 0, ginfo), ainfo] + links + attrs,
                   phase=_attr_phase(self.attrs))
        out = [root]
        for ds in objs:
            fill = bytes([2, 3 if ds.chunked else 2, 2, 1, 0, 0, 0, 0])
            if ds.chunked:
                layout = struct.pack("<BBBQII", 3, 2, 2, UNDEF,
                                     _UNLIMITED_CHUNK, ds.dtype.itemsize)
                space = _space_msg(ds.shape, (None,))
            else:
                layout = struct.pack("<BBQQ", 3, 1, UNDEF if ds.addr is None
                                     else ds.addr, ds.nbytes)
                space = _space_msg(ds.shape)
            out.append(_oh([(0x01, 0, 0, space),
                            (0x03, 1, 0, _dtype_msg(ds.dtype)),
                            (0x05, 1, 0, fill), (0x08, 0, 0, layout)]
                           + _attr_messages(ds.attrs, addr, heap),
                           phase=_attr_phase(ds.attrs)))
        return out

    def close(self):
        """Write the global heap, the object headers and the superblock
        after the data; the file is closed whether or not this raises."""
        if self._fd is None:
            return
        try:
            objs = list(self._datasets.values())
            # DIMENSION_LIST: one heap object per (dataset, axis), holding
            # the addresses of the scales attached there
            keys = [(ds, i) for ds in objs if ds._dim_list
                    for i, s in enumerate(ds._dim_list) if s]
            groups = [keys[k:k + 0xFFFE] for k in range(0, len(keys), 0xFFFE)]
            start = self._end
            heap = {key: (0, 0) for key in keys}
            addr = {ds: 0 for ds in objs}

            def payload(key):
                ds, i = key
                return b"".join(struct.pack("<Q", addr[s])
                                for s in ds._dim_list[i])
            # the headers' sizes do not depend on the addresses they hold:
            # lay them out with zeros, then encode them again
            sizes = [len(_gcol([payload(k) for k in g])) for g in groups]
            pos = start
            for g, size in zip(groups, sizes):
                for j, key in enumerate(g):
                    heap[key] = (pos, j + 1)
                pos += size
            heads = self._headers(addr, heap)
            root_addr = pos
            pos += len(heads[0])
            for ds, h in zip(objs, heads[1:]):
                addr[ds] = pos
                pos += len(h)
            heads = self._headers(addr, heap)
            blob = b"".join(_gcol([payload(k) for k in g]) for g in groups)
            blob += b"".join(heads)
            if start + len(blob) != pos:
                raise FatalError("HDF5 ENCODER: HEADER SIZES CHANGED WITH "
                                 "THEIR ADDRESSES")
            self._pwrite(blob, start)
            sb = (MAGIC + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                  + struct.pack("<HHI", 4, 16, 0)
                  + struct.pack("<4Q", 0, UNDEF, pos, UNDEF)
                  + struct.pack("<QQII", 0, root_addr, 0, 0) + bytes(16))
            self._pwrite(sb, 0)
            os.ftruncate(self._fd, pos)
        finally:
            os.close(self._fd)
            self._fd = None


# ---- reader --------------------------------------------------------------
# What the reader parses, by the specification's sections: superblocks 0-3
# (II.A); version-1 and version-2 object headers (IV.A.1); old-style groups
# (symbol table message, v1 B-tree of type 0, SNOD nodes, local heap:
# III.A.1, III.B, III.D) and new-style groups with compact or dense links
# (link info message, fractal heap, v2 B-trees of types 5 and 6: III.A.2,
# III.G); compact or dense attributes (attribute info message, v2 B-trees
# of types 8 and 9) in attribute messages of versions 1-3; compact,
# contiguous and chunked data (layout message versions 1-4; chunks under a
# v1 B-tree of type 1, or layout 4's single-chunk, implicit, fixed-array,
# extensible-array and v2-B-tree (types 10 and 11) indexes: appendix C),
# through the filters of _FILTERS_READ; huge fractal-heap objects (v2
# B-trees of types 1 and 2).

def _u(b, p, n):
    """The little-endian unsigned integer of ``n`` bytes at ``p``."""
    return int.from_bytes(b[p:p + n], "little")


def _enc_size(n):
    """Bytes that encode counts up to ``n`` (H5VM_limit_enc_size)."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


def _log2(n):
    return int(n).bit_length() - 1


#: filter ids (HDF5's and the registered plugins') for the refusals
_FILTER_NAMES = {1: "DEFLATE", 2: "SHUFFLE", 3: "FLETCHER32", 4: "SZIP",
                 5: "N-BIT", 6: "SCALE-OFFSET", 32000: "LZF",
                 32001: "BLOSC", 32004: "LZ4", 32008: "BITSHUFFLE",
                 32013: "ZFP", 32015: "ZSTD", 32017: "SZ", 307: "BZIP2"}
#: the decoders of io/h5filters.py, by filter id
_FILTER_DECODERS = {4: h5filters.szip, 5: h5filters.nbit,
                    6: h5filters.scale_offset, 32000: h5filters.lzf}
_FILTERS_READ = (1, 2, 3, *_FILTER_DECODERS)
#: the most bytes a filter writes for n bytes in, where that is more than
#: n: HDF5's output buffers for deflate (ceil(1.001 n) + 12) and szip (n
#: + 4, its size header), Fletcher32's checksum, scale-offset's header
_GROWTH = {1: lambda n: n + n // 1000 + 13, 3: lambda n: n + 4,
           4: lambda n: n + 4, 6: lambda n: n + 21}


def fletcher32(data) -> int:
    """H5_checksum_fletcher32 of ``data``: big-endian 16-bit words (an odd
    last byte is the high byte of one more), both sums reduced with end-
    around carry, so a non-zero sum lies in [1, 65535]."""
    b = np.frombuffer(data, np.uint8)
    if b.size % 2:
        b = np.concatenate([b, np.zeros(1, np.uint8)])
    w = b.view(">u2").astype(np.uint64)
    if not w.size:
        return 0
    s1 = int(w.sum())
    # the sum of the running sums: word i counts n - i times
    s2 = int((w * (np.arange(w.size, 0, -1, dtype=np.uint64)
                   % np.uint64(65535))).sum())
    if not s1:
        return 0
    return ((s2 - 1) % 65535 + 1) << 16 | ((s1 - 1) % 65535 + 1)


def _unshuffle(data, size):
    """Undo the shuffle filter: ``size`` byte planes back into elements
    (one strided column store per plane); trailing bytes that fill no
    element stay as they are."""
    n = len(data) // size
    if size <= 1 or n <= 1:
        return data
    planes = np.frombuffer(data, np.uint8, count=n * size).reshape(size, n)
    out = np.empty(len(data), np.uint8)
    cols = out[:n * size].reshape(n, size)
    for k in range(size):
        cols[:, k] = planes[k]
    out[n * size:] = np.frombuffer(data, np.uint8, offset=n * size)
    return out


def _pipeline(m, where):
    """[(filter id, client data)] of a filter pipeline message (IV.A.2.l),
    in the order the filters were applied when writing; a filter this
    module does not decode raises, naming it."""
    ver, n = m[0], m[1]
    p = 8 if ver == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", m, p)[0]
        p += 2
        nlen = 0
        if ver == 1 or fid >= 256:
            nlen = struct.unpack_from("<H", m, p)[0]
            p += 2
        _, ncd = struct.unpack_from("<HH", m, p)
        p += 4 + (nlen + (-nlen % 8) if ver == 1 else nlen)
        cd = struct.unpack_from(f"<{ncd}I", m, p)
        p += 4 * ncd + (4 if ver == 1 and ncd % 2 else 0)
        if fid not in _FILTERS_READ:
            raise FatalError(
                f"{where}: FILTER {fid} ({_FILTER_NAMES.get(fid, 'UNKNOWN')}) "
                "NOT SUPPORTED")
        out.append((fid, cd))
    return out


def _unfilter(raw, filters, mask, where, itemsize, nbytes):
    """Bytes through the filters of a pipeline not masked off, last
    first; ``where`` names them in errors, ``itemsize`` is the shuffle's
    element size where its client data gives none, ``nbytes`` the
    unfiltered size, which bounds what each decoder may make."""
    limits = [nbytes]
    for fid, _ in filters[:-1]:
        limits.append(_GROWTH.get(fid, lambda n: n)(limits[-1]))
    data = raw
    for i in range(len(filters) - 1, -1, -1):
        if mask >> i & 1:
            continue
        fid, cd = filters[i]
        if fid in _FILTER_DECODERS:
            data = _FILTER_DECODERS[fid](data, cd, where, limits[i])
        elif fid == 1:
            try:
                data = zlib.decompress(data)
            except zlib.error as e:
                raise FatalError(f"{where}: FILTER 1 (DEFLATE): {e}") \
                    from None
        elif fid == 2:
            data = _unshuffle(data, cd[0] if cd else itemsize)
        else:
            body, stored = data[:-4], _u(data, len(data) - 4, 4)
            want = fletcher32(body)
            # HDF5 1.6 stored it with the bytes of each half swapped
            swapped = ((want & 0xFF00FF00) >> 8) | ((want & 0x00FF00FF)
                                                    << 8)
            if stored not in (want, swapped):
                raise FatalError(f"{where}: FLETCHER32 CHECKSUM MISMATCH")
            data = body
    return data


class _Object:
    """One object header's messages: (type, flags, creation index, body)."""

    def __init__(self, f, addr):
        buf = f._buf
        if bytes(buf[addr:addr + 4]) == b"OHDR":
            self.messages = self._v2(f, addr)
        elif buf[addr] == 1:
            self.messages = self._v1(f, addr)
        else:
            raise FatalError(f"{f.path}: OBJECT HEADER AT {addr}: "
                             "UNKNOWN VERSION")
        for t, fl, _, _ in self.messages:
            if fl & 2:
                raise FatalError(f"{f.path}: OBJECT HEADER AT {addr}: "
                                 f"SHARED MESSAGE (TYPE {t}) NOT SUPPORTED")

    def _v2(self, f, addr):
        buf = f._buf
        flags = buf[addr + 5]
        p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10
                                                        else 0)
        w = 1 << (flags & 3)
        size = int.from_bytes(buf[p:p + w], "little")
        p += w
        self.crt_tracked = bool(flags & 0x04)
        blocks, msgs = [(addr, p, p + size)], []
        while blocks:
            start, p, end = blocks.pop(0)
            if struct.unpack_from("<I", buf, end)[0] != lookup3(
                    bytes(buf[start:end])):
                raise FatalError(f"{f.path}: OBJECT HEADER AT {addr}: "
                                 "CHECKSUM MISMATCH")
            hs = 6 if self.crt_tracked else 4
            while end - p >= hs:
                t, sz, fl = struct.unpack_from("<BHB", buf, p)
                crt = (struct.unpack_from("<H", buf, p + 4)[0]
                       if self.crt_tracked else 0)
                body = bytes(buf[p + hs:p + hs + sz])
                p += hs + sz
                if t == 0x10:
                    ca, cl = struct.unpack_from("<QQ", body)
                    if bytes(buf[ca:ca + 4]) != b"OCHK":
                        raise FatalError(f"{f.path}: CONTINUATION BLOCK AT "
                                         f"{ca}: NO OCHK SIGNATURE")
                    blocks.append((ca, ca + 4, ca + cl - 4))
                elif t:
                    msgs.append((t, fl, crt, body))
        return msgs

    def _v1(self, f, addr):
        buf = f._buf
        size = struct.unpack_from("<I", buf, addr + 8)[0]
        self.crt_tracked = False
        blocks, msgs = [(addr + 16, addr + 16 + size)], []
        while blocks:
            p, end = blocks.pop(0)
            while p + 8 <= end:
                t, sz, fl = struct.unpack_from("<HHB", buf, p)
                body = bytes(buf[p + 8:p + 8 + sz])
                p += 8 + sz
                if t == 0x10:
                    ca, cl = struct.unpack_from("<QQ", body)
                    blocks.append((ca, ca + cl))
                elif t:
                    msgs.append((t, fl, 0, body))
        return msgs

    def find(self, t):
        return [m for m in self.messages if m[0] == t]


def _decode_type(path, b, p=0):
    """(numpy dtype, ("vlen", base dtype) or ("vlen_str", charset), end)
    of the datatype at ``p``."""
    cls, ver = b[p] & 0x0F, b[p] >> 4
    bits = b[p + 1] | b[p + 2] << 8 | b[p + 3] << 16
    size = struct.unpack_from("<I", b, p + 4)[0]
    p += 8
    order = ">" if bits & 1 else "<"
    if cls in (0, 1) and size not in ((1, 2, 4, 8), (2, 4, 8))[cls]:
        kind = ("INTEGER", "FLOATING-POINT")[cls]
        raise FatalError(f"{path}: {kind} DATATYPE OF {size} BYTES NOT "
                         "SUPPORTED")
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"), p + 4
    if cls == 1:
        return np.dtype(f"{order}f{size}"), p + 12
    if cls == 3:
        return np.dtype(f"S{size}"), p
    if cls == 7 and (bits & 0x0F) == 0:
        return np.dtype("<u8"), p            # an object reference: address
    if cls == 9 and (bits & 0x0F) == 0:
        base, p = _decode_type(path, b, p)
        return ("vlen", base), p
    if cls == 9 and (bits & 0x0F) == 1:
        _, p = _decode_type(path, b, p)      # the base: a 1-byte char
        return ("vlen_str", (bits >> 8) & 0x0F), p
    if cls == 6:
        names, formats, offsets = [], [], []
        for _ in range(bits & 0xFFFF):
            e = b.index(b"\0", p)
            names.append(b[p:e].decode())
            if ver >= 3:             # versions 3 and 4: packed names
                p = e + 1
                w = next(k for k in (1, 2, 3, 4) if size < 1 << (8 * k))
                offsets.append(int.from_bytes(b[p:p + w], "little"))
                p += w
            else:
                p = e + 1 + (-(e + 1 - p) % 8)
                offsets.append(struct.unpack_from("<I", b, p)[0])
                p += 4 + (28 if ver == 1 else 0)
            mt, p = _decode_type(path, b, p)
            if not isinstance(mt, np.dtype):
                raise FatalError(f"{path}: COMPOUND MEMBER OF TYPE {mt}")
            formats.append(mt)
        return np.dtype({"names": names, "formats": formats,
                         "offsets": offsets, "itemsize": size}), p
    kinds = {2: "time", 4: "bitfield", 5: "opaque", 7: "region reference",
             8: "enumerated", 9: "variable-length", 10: "array"}
    raise FatalError(f"{path}: DATATYPE CLASS {cls} "
                     f"({kinds.get(cls, 'unknown')}) NOT SUPPORTED")


def _decode_space(b):
    """Shape tuple, () for scalar, None for the null dataspace."""
    ver, rank = b[0], b[1]
    if ver == 1:
        p = 8
    else:
        p = 4
        if b[3] == 2:
            return None
    return tuple(struct.unpack_from(f"<{rank}Q", b, p)) if rank else ()


def _decode_maxshape(b):
    """The maximum dimensions of a simple dataspace (the dimensions where
    none are stored), None for an unlimited one."""
    rank, p = b[1], 8 if b[0] == 1 else 4
    if not b[2] & 1:
        return _decode_space(b)
    dims = struct.unpack_from(f"<{rank}Q", b, p + 8 * rank)
    return tuple(None if d == UNDEF else d for d in dims)


def _checked(f, start, end, what):
    """Verify the Jenkins lookup3 checksum that follows ``[start, end)``."""
    if struct.unpack_from("<I", f._buf, end)[0] != lookup3(
            bytes(f._buf[start:end])):
        raise FatalError(f"{f.path}: {what} AT {start}: CHECKSUM MISMATCH")


def _signature(f, addr, sig, what):
    """Check the 4-byte signature ``sig`` of a structure at ``addr``."""
    if bytes(f._buf[addr:addr + 4]) != sig:
        raise FatalError(f"{f.path}: NO {what} AT {addr}")


def _page_set(bitmap, k):
    """Bit ``k`` of a page-init bitmap (most significant bit first)."""
    return bool(bitmap[k // 8] & (0x80 >> (k % 8)))


def _fixed_array(f, addr):
    """The elements of the fixed array at ``addr`` (appendix C, "Fixed
    Array Index"; HDF5's H5FA): (raw element bytes in index order,
    element size, filtered). Its data block holds the elements, or past
    2**page-bits of them a page-init bitmap and pages of its own; a page
    never initialized holds undefined addresses."""
    buf = f._buf
    _signature(f, addr, b"FAHD", "FIXED ARRAY HEADER")
    client, esize, page_bits = buf[addr + 5], buf[addr + 6], buf[addr + 7]
    nelmts, dblk = struct.unpack_from("<QQ", buf, addr + 8)
    _checked(f, addr, addr + 24, "FIXED ARRAY HEADER")
    if dblk == UNDEF:
        return b"", esize, client == 1
    _signature(f, dblk, b"FADB", "FIXED ARRAY DATA BLOCK")
    p = dblk + 14
    page_n = 1 << page_bits
    if nelmts <= page_n:
        _checked(f, dblk, p + nelmts * esize, "FIXED ARRAY DATA BLOCK")
        return bytes(buf[p:p + nelmts * esize]), esize, client == 1
    npages = -(-nelmts // page_n)
    init = bytes(buf[p:p + (npages + 7) // 8])
    p += len(init)
    _checked(f, dblk, p, "FIXED ARRAY DATA BLOCK")
    p += 4
    parts = []
    for k in range(npages):
        n = min(page_n, nelmts - k * page_n)
        if _page_set(init, k):
            _checked(f, p, p + n * esize, "FIXED ARRAY PAGE")
            parts.append(bytes(buf[p:p + n * esize]))
        else:
            parts.append(b"\xff" * (n * esize))
        p += page_n * esize + 4
    return b"".join(parts), esize, client == 1


def _extensible_array(f, addr):
    """The elements of the extensible array at ``addr`` (appendix C,
    "Extensible Array Index"; HDF5's H5EA), up to its largest index set:
    (raw element bytes in index order, element size, filtered). The
    index block holds the
    first elements, the data blocks of the first super blocks and the
    addresses of the others; super block ``u`` has 2**(u//2) data blocks
    of 2**((u+1)//2) times the minimum elements, paged (a page-init bitmap
    per data block in the super block) past 2**page-bits elements."""
    buf = f._buf
    _signature(f, addr, b"EAHD", "EXTENSIBLE ARRAY HEADER")
    (client, esize, max_bits, idx_elmts, dblk_min, sblk_min,
     page_bits) = buf[addr + 5:addr + 12]
    max_set = struct.unpack_from("<Q", buf, addr + 44)[0]
    iblock = _u(buf, addr + 60, 8)
    _checked(f, addr, addr + 68, "EXTENSIBLE ARRAY HEADER")
    out = bytearray(b"\xff" * (max_set * esize))
    if iblock == UNDEF or not max_set:
        return bytes(out), esize, client == 1
    arr_off = (max_bits + 7) // 8
    page_n = 1 << page_bits

    def place(first, raw):
        n = max(min(len(raw) // esize, max_set - first), 0)
        out[first * esize:(first + n) * esize] = raw[:n * esize]

    def data_block(at, nel, first, init, bit0):
        _signature(f, at, b"EADB", "EXTENSIBLE ARRAY DATA BLOCK")
        p = at + 14 + arr_off
        if nel <= page_n:
            _checked(f, at, p + nel * esize, "EXTENSIBLE ARRAY DATA BLOCK")
            place(first, bytes(buf[p:p + nel * esize]))
            return
        if init is None:
            raise FatalError(f"{f.path}: EXTENSIBLE ARRAY AT {addr}: A PAGED "
                             "DATA BLOCK IN THE INDEX BLOCK NOT SUPPORTED")
        _checked(f, at, p, "EXTENSIBLE ARRAY DATA BLOCK")
        p += 4
        for k in range(nel // page_n):
            if _page_set(init, bit0 + k):
                _checked(f, p, p + page_n * esize, "EXTENSIBLE ARRAY PAGE")
                place(first + k * page_n, bytes(buf[p:p + page_n * esize]))
            p += page_n * esize + 4

    _signature(f, iblock, b"EAIB", "EXTENSIBLE ARRAY INDEX BLOCK")
    p = iblock + 14
    place(0, bytes(buf[p:p + idx_elmts * esize]))
    p += idx_elmts * esize
    nsblks = 1 + max_bits - _log2(dblk_min)
    ib_sblks = 2 * _log2(sblk_min)
    dblk_addrs = struct.unpack_from(f"<{2 * (sblk_min - 1)}Q", buf, p)
    p += 16 * (sblk_min - 1)
    sblk_addrs = struct.unpack_from(f"<{nsblks - ib_sblks}Q", buf, p)
    p += 8 * (nsblks - ib_sblks)
    _checked(f, iblock, p, "EXTENSIBLE ARRAY INDEX BLOCK")
    first, dblk_no = idx_elmts, 0
    for u in range(nsblks):
        if first >= max_set:
            break
        nd, dn = 1 << (u // 2), (1 << ((u + 1) // 2)) * dblk_min
        if u < ib_sblks:
            addrs, init, npages = dblk_addrs[dblk_no:dblk_no + nd], None, 0
        else:
            s = sblk_addrs[u - ib_sblks]
            if s == UNDEF:
                first, dblk_no = first + nd * dn, dblk_no + nd
                continue
            _signature(f, s, b"EASB", "EXTENSIBLE ARRAY SUPER BLOCK")
            q = s + 14 + arr_off
            npages = dn // page_n if dn > page_n else 0
            init = bytes(buf[q:q + nd * ((npages + 7) // 8)])
            q += len(init)
            addrs = struct.unpack_from(f"<{nd}Q", buf, q)
            _checked(f, s, q + 8 * nd, "EXTENSIBLE ARRAY SUPER BLOCK")
        for d, a in enumerate(addrs):
            if a != UNDEF and first + d * dn < max_set:
                data_block(a, dn, first + d * dn, init, d * npages)
        first, dblk_no = first + nd * dn, dblk_no + nd
    return bytes(out), esize, client == 1


def _chunk_elements(raw, esize, filtered):
    """Addresses, stored sizes and filter masks of chunk index elements
    (an address; filtered: an address, the stored size in the bytes left
    over, a 4-byte filter mask)."""
    n = len(raw) // esize
    a = np.frombuffer(raw, np.uint8, count=n * esize).reshape(n, esize)
    addr = a[:, :8].copy().view("<u8").ravel()
    if not filtered:
        return addr, None, np.zeros(n, np.uint32)
    size = np.zeros(n, np.uint64)
    for i in range(esize - 12):
        size |= a[:, 8 + i].astype(np.uint64) << np.uint64(8 * i)
    return addr, size, a[:, esize - 4:].copy().view("<u4").ravel()


class _FractalHeap:
    """A fractal heap (III.G): its header, and its direct blocks found
    through the doubling table of the root (a direct block, or an
    indirect block whose rows hold direct blocks and, past the largest
    direct block size, indirect blocks)."""

    def __init__(self, f, addr):
        self.f, buf, path = f, f._buf, f.path
        _signature(f, addr, b"FRHP", "FRACTAL HEAP HEADER")
        self.id_len, filt_len, self.flags = struct.unpack_from(
            "<HHB", buf, addr + 5)
        max_man, _, self.huge_bt = struct.unpack_from("<IQQ", buf, addr + 10)
        (self.width, start, max_direct, self.max_heap_bits, _, root,
         self.root_rows) = struct.unpack_from("<HQQHHQH", buf, addr + 110)
        # a filtered heap: the root direct block's filtered size and mask,
        # then the I/O filter pipeline message
        end = addr + 142 + (12 + filt_len if filt_len else 0)
        _checked(f, addr, end, "FRACTAL HEAP")
        self.addr = addr
        self.filters = (_pipeline(bytes(buf[addr + 154:end]),
                                  f"{path}: FRACTAL HEAP AT {addr}")
                        if filt_len else None)
        if self.filters and root != UNDEF:
            raise FatalError(f"{path}: FRACTAL HEAP AT {addr}: FILTERED "
                             "(COMPRESSED) HEAP BLOCKS NOT SUPPORTED")
        self._huge = None
        self.off_size = (self.max_heap_bits + 7) // 8
        self.len_size = min((_log2(max_direct) + 7) // 8,
                            _enc_size(max_man))
        self.first_row_bits = _log2(start) + _log2(self.width)
        self.max_direct_rows = _log2(max_direct) - _log2(start) + 2
        rows = max(self.max_heap_bits - self.first_row_bits, 2)
        self.row_size = [start] + [start << max(r - 1, 0)
                                   for r in range(1, rows)]
        self.blocks = []       # (heap offset, address, size), by offset
        if root == UNDEF:
            return
        if self.root_rows == 0:
            self._direct(root, 0, start)
        else:
            self._indirect(root, 0, self.root_rows)
        self.blocks.sort()

    def _direct(self, addr, off, size):
        buf, path = self.f._buf, self.f.path
        _signature(self.f, addr, b"FHDB", "FRACTAL HEAP DIRECT BLOCK")
        if self.flags & 2:
            at = addr + 13 + self.off_size
            raw = bytearray(buf[addr:addr + size])
            stored = struct.unpack_from("<I", raw, at - addr)[0]
            raw[at - addr:at - addr + 4] = bytes(4)
            if stored != lookup3(bytes(raw)):
                raise FatalError(f"{path}: FRACTAL HEAP DIRECT BLOCK AT "
                                 f"{addr}: CHECKSUM MISMATCH")
        self.blocks.append((off, addr, size))

    def _indirect(self, addr, off, nrows):
        buf = self.f._buf
        _signature(self.f, addr, b"FHIB", "FRACTAL HEAP INDIRECT BLOCK")
        p = addr + 13 + self.off_size
        children = []
        for r in range(nrows):
            for _ in range(self.width):
                child = _u(buf, p, 8)
                p += 8
                if child != UNDEF:
                    children.append((r, child, off))
                off += self.row_size[r]
        _checked(self.f, addr, p, "FRACTAL HEAP INDIRECT BLOCK")
        for r, child, at in children:
            if r < self.max_direct_rows:
                self._direct(child, at, self.row_size[r])
            else:
                self._indirect(child, at, _log2(self.row_size[r])
                               - self.first_row_bits + 1)

    def get(self, hid):
        """The object of heap ID ``hid`` (bytes)."""
        path = self.f.path
        kind = (hid[0] >> 4) & 3
        if kind == 2:                                   # tiny: in the ID
            if self.id_len <= 18:
                n = (hid[0] & 0x0F) + 1
                return bytes(hid[1:1 + n])
            n = ((hid[0] & 0x0F) << 8 | hid[1]) + 1
            return bytes(hid[2:2 + n])
        if kind == 1:
            return self._huge_object(hid)
        if kind:
            raise FatalError(f"{path}: FRACTAL HEAP AT {self.addr}: HEAP ID "
                             f"OF TYPE {kind}")
        off = _u(hid, 1, self.off_size)
        n = _u(hid, 1 + self.off_size, self.len_size)
        i = bisect.bisect_right(self.blocks, (off, UNDEF, 0)) - 1
        if i < 0 or off + n > self.blocks[i][0] + self.blocks[i][2]:
            raise FatalError(f"{path}: FRACTAL HEAP AT {self.addr}: NO "
                             f"BLOCK HOLDS OFFSET {off}")
        start, addr, _ = self.blocks[i]
        return bytes(self.f._buf[addr + off - start:addr + off - start + n])

    def _huge_object(self, hid):
        """A huge object, stored outside the heap's blocks (III.G): its
        address and length (filtered: also its filter mask and size) in
        the heap ID where the ID is wide enough, else in the record of the
        heap's v2 B-tree (type 1, or 2 filtered) under the ID's key."""
        where = f"{self.f.path}: FRACTAL HEAP AT {self.addr}: HUGE OBJECT"
        filtered = self.filters is not None
        if self.id_len - 1 >= (28 if filtered else 16):       # direct
            at, n = _u(hid, 1, 8), _u(hid, 9, 8)
            mask = _u(hid, 17, 4) if filtered else 0
            size = _u(hid, 21, 8) if filtered else 0
        else:
            if self._huge is None:
                btype, recs = _btree2_records(self.f, self.huge_bt)
                if btype != (2 if filtered else 1):
                    raise FatalError(f"{where}: INDEX OF V2 B-TREE TYPE "
                                     f"{btype}")
                # type 1: address, length, ID; type 2: address, length,
                # filter mask, unfiltered size, ID
                self._huge = {
                    _u(r, len(r) - 8, 8): (_u(r, 0, 8), _u(r, 8, 8),
                                           _u(r, 16, 4) if filtered else 0,
                                           _u(r, 20, 8) if filtered else 0)
                    for r in recs}
            key = _u(hid, 1, min(self.id_len - 1, 8))
            if key not in self._huge:
                raise FatalError(f"{where}: NO RECORD OF ID {key}")
            at, n, mask, size = self._huge[key]
        raw = bytes(self.f._buf[at:at + n])
        if len(raw) != n:
            raise FatalError(f"{where}: {n} BYTES AT {at} PAST THE FILE'S "
                             "END")
        return (_unfilter(raw, self.filters, mask, where, 1, size)
                if filtered else raw)


def _btree2_records(f, addr):
    """Every record of the v2 B-tree at ``addr`` (III.A.2), in key order:
    (type, [record bytes])."""
    buf = f._buf
    _signature(f, addr, b"BTHD", "V2 B-TREE HEADER")
    btype = buf[addr + 5]
    node_size, rsize, depth = struct.unpack_from("<IHH", buf, addr + 6)
    root, nroot = struct.unpack_from("<QH", buf, addr + 16)
    _checked(f, addr, addr + 34, "V2 B-TREE")
    # H5B2__hdr_init: the largest record count of a node at each depth and
    # of the subtree under it, and the bytes that encode them
    max_nrec = [(node_size - 10) // rsize]
    cum = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _enc_size(max_nrec[0])
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - 10 - ptr) // (rsize + ptr))
        cum.append((max_nrec[d] + 1) * cum[d - 1] + max_nrec[d])
        cum_size.append(_enc_size(cum[d]))
    out = []

    def node(at, nrec, d):
        _signature(f, at, b"BTIN" if d else b"BTLF", "V2 B-TREE NODE")
        recs = [bytes(buf[at + 6 + i * rsize:at + 6 + (i + 1) * rsize])
                for i in range(nrec)]
        p = at + 6 + nrec * rsize
        kids = []
        if d:
            for _ in range(nrec + 1):
                kids.append((_u(buf, p, 8), _u(buf, p + 8, nrec_size)))
                p += 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        _checked(f, at, p, "V2 B-TREE NODE")
        for i, r in enumerate(recs):
            if d:
                node(*kids[i], d - 1)
            out.append(r)
        if d:
            node(*kids[nrec], d - 1)

    if root != UNDEF and nroot:
        node(root, nroot, depth)
    return btype, out


def _btree1_entries(f, addr, key_size):
    """(key bytes, child address) of every leaf entry of the v1 B-tree at
    ``addr`` (III.A.1), in key order: symbol table nodes (type 0) or
    chunks (type 1)."""
    buf = f._buf
    out, todo = [], [addr]
    while todo:
        at = todo.pop()
        _signature(f, at, b"TREE", "V1 B-TREE NODE")
        level, used = buf[at + 5], struct.unpack_from("<H", buf, at + 6)[0]
        p = at + 24
        entries = []
        for _ in range(used):
            entries.append((bytes(buf[p:p + key_size]),
                            _u(buf, p + key_size, 8)))
            p += key_size + 8
        if level:
            todo.extend(c for _, c in reversed(entries))
        else:
            out.extend(entries)
    return out


class _RDataset(Dataset):
    """A dataset of a parsed file."""

    def __init__(self, f, name, obj):
        self._f, self.name, self._obj = f, "/" + name, obj
        path = f.path
        (_, _, _, space), = obj.find(0x01)
        self.shape = _decode_space(space) or ()
        (_, _, _, dtype), = obj.find(0x03)
        self.dtype, _ = _decode_type(path, dtype)
        if not isinstance(self.dtype, np.dtype):
            raise FatalError(f"{path}: {name}: VARIABLE-LENGTH DATA NOT "
                             "SUPPORTED")
        # a number held in fewer bits than its size: (bit offset, precision)
        self._bits = None
        if dtype[0] & 0x0F in (0, 1):
            bits = struct.unpack_from("<HH", dtype, 8)
            if bits != (0, 8 * self.dtype.itemsize):
                self._bits = bits
                if dtype[0] & 0x0F:
                    raise FatalError(self._where(
                        f"FLOATING-POINT DATATYPE OF PRECISION {bits[1]} AT "
                        f"BIT OFFSET {bits[0]} NOT SUPPORTED"))
        self.attrs = f._attrs(obj)

    @property
    def dims(self):
        dl = self.attrs.get("DIMENSION_LIST")
        if dl is None:
            return [[] for _ in self.shape]
        return [[self._f._by_addr(a) for a in refs] for refs in dl]

    def storage(self) -> dict:
        """How the data is stored, for reports: ``layout`` ("compact",
        "contiguous" or "chunked"), ``index`` (a chunked dataset's chunk
        index: "btree1", "single", "implicit", "farray", "earray" or
        "btree2"; else None), ``filters`` (the pipeline's filter names, in
        the order they were applied when writing) and ``allocated``
        (False where no data was ever written)."""
        lay = self._layout()
        chunked = lay[0] == "chunked"
        return {"layout": lay[0], "index": lay[1] if chunked else None,
                "filters": [_FILTER_NAMES[fid].lower()
                            for fid, _ in self._filters()],
                "allocated": lay[0] == "compact"
                or (lay[2] if chunked else lay[1]) != UNDEF}

    def _where(self, what):
        return f"{self._f.path}: {self.name}: {what}"

    def _layout(self):
        """("compact", bytes), ("contiguous", address) or ("chunked",
        index, address, chunk shape, single chunk's (filtered size, filter
        mask)); the index is "btree1", "single", "implicit", "farray",
        "earray" or "btree2"."""
        (_, _, _, lay), = self._obj.find(0x08)
        ver, rank = lay[0], len(self.shape)
        if ver in (1, 2):
            nd, cls, p = lay[1], lay[2], 8
            addr = None
            if cls:
                addr, p = _u(lay, p, 8), p + 8
            dims = struct.unpack_from(f"<{nd}I", lay, p)
            p += 4 * nd
            if cls == 0:
                n = struct.unpack_from("<I", lay, p)[0]
                return "compact", lay[p + 4:p + 4 + n]
            if cls == 1:
                return "contiguous", addr
            return "chunked", "btree1", addr, dims[:rank], None
        if ver not in (3, 4):
            raise FatalError(self._where(f"DATA LAYOUT MESSAGE VERSION {ver}"
                                         " NOT SUPPORTED"))
        cls = lay[1]
        if cls == 0:
            n = struct.unpack_from("<H", lay, 2)[0]
            return "compact", lay[4:4 + n]
        if cls == 1:
            if self._obj.find(0x07):
                raise FatalError(self._where("EXTERNAL STORAGE (EXTERNAL "
                                             "DATA FILES) NOT SUPPORTED"))
            return "contiguous", _u(lay, 2, 8)
        if cls == 2 and ver == 3:
            nd = lay[2]
            return ("chunked", "btree1", _u(lay, 3, 8),
                    struct.unpack_from(f"<{nd}I", lay, 11)[:rank], None)
        if cls == 2:
            flags, nd, w = lay[2], lay[3], lay[4]
            if flags & 1 and self._obj.find(0x0B):
                raise FatalError(self._where(
                    "PARTIAL EDGE CHUNKS STORED UNFILTERED NOT SUPPORTED"))
            dims = [_u(lay, 5 + i * w, w) for i in range(nd)][:rank]
            p = 5 + nd * w
            index = lay[p]
            # the index's parameters: a filtered single chunk's size and
            # mask; page bits (fixed array); five bytes (extensible
            # array); node size, split and merge percents (v2 B-tree)
            p += 1 + {1: 12 if flags & 2 else 0, 2: 0, 3: 1, 4: 5,
                      5: 6}.get(index, 0)
            single = ((_u(lay, p - 12, 8), _u(lay, p - 4, 4))
                      if index == 1 and flags & 2 else None)
            kinds = {1: "single", 2: "implicit", 3: "farray", 4: "earray",
                     5: "btree2"}
            if index not in kinds:
                raise FatalError(self._where(
                    f"CHUNK INDEX TYPE {index} (DATA LAYOUT VERSION 4) NOT "
                    "SUPPORTED"))
            return "chunked", kinds[index], _u(lay, p, 8), dims, single
        kind = {3: "VIRTUAL"}.get(cls, f"CLASS {cls}")
        raise FatalError(self._where(f"{kind} LAYOUT NOT SUPPORTED"))

    def _filters(self):
        """[(filter id, client data)] of the filter pipeline message, in
        the order they were applied when writing."""
        msgs = self._obj.find(0x0B)
        return (_pipeline(msgs[0][3], f"{self._f.path}: {self.name}")
                if msgs else [])

    def _fill(self):
        """The fill value of a version-2 or -3 fill value message, 0 where
        none is given."""
        for _, _, _, m in self._obj.find(0x05):
            if m[0] == 3:
                raw = m[6:6 + struct.unpack_from("<I", m, 2)[0]] \
                    if m[1] & 0x20 else b""
            else:
                raw = m[8:8 + struct.unpack_from("<I", m, 4)[0]] \
                    if m[3] else b""
            if len(raw) == self.dtype.itemsize:
                return np.frombuffer(raw, self.dtype)[0]
        return 0

    def _chunks(self, lay):
        """[(chunk offset, address, stored bytes, filter mask)] of every
        chunk written, and the chunk shape."""
        _, index, addr, cdims, single = lay
        if addr == UNDEF:
            return [], cdims
        f, rank = self._f, len(self.shape)
        nbytes = int(np.prod(cdims, dtype=np.int64)) * self.dtype.itemsize
        if index == "btree1":
            out = []
            # a key: chunk bytes, filter mask, rank + 1 offsets (the last
            # the element-size axis, 0)
            for key, child in _btree1_entries(f, addr, 8 + 8 * (rank + 1)):
                size, mask = struct.unpack_from("<II", key)
                out.append((struct.unpack_from(f"<{rank}Q", key, 8), child,
                            size, mask))
            return out, cdims
        if index == "single":
            size, mask = single or (nbytes, 0)
            return [((0,) * rank, addr, size, mask)], cdims
        if index == "btree2":
            return self._btree2_chunks(addr, cdims, nbytes), cdims
        # the linear chunk index of an array index runs over the chunks of
        # the maximum dimensions (a fixed array; a grid of them as implicit)
        # or, for an extensible array, over the unlimited dimension first
        # and the others' maximum chunks, in their order, after it
        (_, _, _, space), = self._obj.find(0x01)
        maxshape = _decode_maxshape(space)
        grid = [-(-(s if m is None else m) // c)
                for s, m, c in zip(self.shape, maxshape, cdims)]
        if index == "implicit":
            idx = np.arange(int(np.prod(grid, dtype=np.int64)))
            addrs = addr + idx.astype(np.uint64) * np.uint64(nbytes)
            sizes, masks = None, np.zeros(len(idx), np.uint32)
        else:
            raw, esize, filtered = (_fixed_array if index == "farray"
                                    else _extensible_array)(f, addr)
            addrs, sizes, masks = _chunk_elements(raw, esize, filtered)
            idx = np.flatnonzero(addrs != np.uint64(UNDEF))
            addrs, masks = addrs[idx], masks[idx]
            sizes = None if sizes is None else sizes[idx]
        if index == "earray":
            unlim = [m is None for m in maxshape].index(True)
            rest = grid[:unlim] + grid[unlim + 1:]
            n_rest = int(np.prod(rest, dtype=np.int64))
            coords = np.unravel_index(idx % n_rest, rest) if rest else ()
            coords = [*coords[:unlim], idx // n_rest, *coords[unlim:]]
        else:
            coords = np.unravel_index(idx, grid)
        offsets = np.stack([np.asarray(c, np.int64) * n
                            for c, n in zip(coords, cdims)], axis=1)
        sizes = [nbytes] * len(idx) if sizes is None else sizes.tolist()
        return list(zip(map(tuple, offsets.tolist()), addrs.tolist(), sizes,
                        masks.tolist())), cdims

    def _btree2_chunks(self, addr, cdims, nbytes):
        """The chunks of a v2 B-tree index: records of type 10 (address,
        scaled offsets) or 11 (address, stored size in the bytes left over,
        filter mask, scaled offsets)."""
        rank = len(self.shape)
        btype, recs = _btree2_records(self._f, addr)
        if btype not in (10, 11):
            raise FatalError(self._where(f"CHUNK INDEX OF V2 B-TREE TYPE "
                                         f"{btype}"))
        out = []
        for r in recs:
            at = _u(r, 0, 8)
            tail = len(r) - 8 * rank
            scaled = struct.unpack_from(f"<{rank}Q", r, tail)
            size, mask = ((_u(r, 8, tail - 12), _u(r, tail - 4, 4))
                          if btype == 11 else (nbytes, 0))
            out.append((tuple(s * c for s, c in zip(scaled, cdims)), at, size,
                        mask))
        return out

    def _read_chunked(self, lay):
        """Decode chunk by chunk into one preallocated array: edge chunks
        cropped to the dataspace, chunks never written the fill value."""
        buf, shape = self._f._buf, self.shape
        filters = self._filters()
        chunks, cdims = self._chunks(lay)
        cdims = tuple(int(c) for c in cdims)
        inside = [c for c in chunks if all(o < s for o, s in zip(c[0],
                                                                 shape))]
        total = int(np.prod([-(-s // c) for s, c in zip(shape, cdims)],
                            dtype=np.int64))
        if len({c[0] for c in inside}) < total or not total:
            out = np.full(shape, self._fill(), self.dtype)
        else:
            out = np.empty(shape, self.dtype)
        n = int(np.prod(cdims, dtype=np.int64))
        for off, addr, size, mask in inside:
            raw = buf[addr:addr + size]
            data = (_unfilter(raw, filters, mask,
                              self._where(f"CHUNK AT {addr}"),
                              self.dtype.itemsize, n * self.dtype.itemsize)
                    if filters else raw)
            if len(data) < n * self.dtype.itemsize:
                raise FatalError(self._where(
                    f"CHUNK AT {addr} HOLDS {len(data)} BYTES, NOT "
                    f"{n * self.dtype.itemsize}"))
            chunk = np.frombuffer(data, self.dtype, count=n).reshape(cdims)
            sel = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(off, cdims, shape))
            out[sel] = chunk[tuple(slice(0, s.stop - s.start)
                                   for s in sel)]
        return out

    def __getitem__(self, key):
        if key is not Ellipsis and key != ():
            raise FatalError(self._where("ONLY [...] IS READ"))
        out = self._read()
        if self._bits is None:
            return out
        # HDF5's integer conversion to the full-size type: the precision
        # bits at the bit offset, sign-extended where signed
        off, prec = self._bits
        v = (out.astype(out.dtype.newbyteorder("=")).view(
            f"u{out.dtype.itemsize}").astype(np.uint64) >> np.uint64(off)) \
            & np.uint64((1 << prec) - 1)
        if self.dtype.kind == "i":
            v = v.astype(np.int64)
            v = np.where(v >> (prec - 1) & 1, v - (1 << prec), v)
        return v.astype(self.dtype)

    def _read(self):
        lay = self._layout()
        n = int(np.prod(self.shape, dtype=np.int64))
        if lay[0] == "compact":
            return np.frombuffer(lay[1], self.dtype, count=n).reshape(
                self.shape).copy()
        if lay[0] != "contiguous":
            return self._read_chunked(lay)
        if lay[1] == UNDEF:
            return np.full(self.shape, self._fill(), self.dtype)
        return np.frombuffer(self._f._buf, self.dtype, count=n,
                             offset=lay[1]).reshape(self.shape).copy()


class _Reader:
    """The reader behind ``open_file(path, "r")``."""

    def __init__(self, path):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._buf = mmap.mmap(self._fh.fileno(), 0,
                                  access=mmap.ACCESS_READ)
        except ValueError:                   # an empty file
            self._fh.close()
            raise FatalError(f"{path}: NOT AN HDF5 FILE") from None
        self._gcols, self._objs = {}, {}
        try:
            self._open()
        except BaseException:
            self.close()
            raise

    def _open(self):
        buf, path = self._buf, self.path
        if bytes(buf[:8]) != MAGIC:
            raise FatalError(f"{path}: NO HDF5 SUPERBLOCK AT OFFSET 0")
        ver = buf[8]
        if ver in (0, 1):
            sizes = buf[13], buf[14]
        elif ver in (2, 3):
            sizes = buf[9], buf[10]
        else:
            raise FatalError(f"{path}: SUPERBLOCK VERSION {ver} NOT "
                             "SUPPORTED")
        if sizes != (8, 8):
            raise FatalError(f"{path}: OFFSETS OF {sizes[0]} AND LENGTHS OF "
                             f"{sizes[1]} BYTES NOT SUPPORTED")
        if ver < 2:
            base = _u(buf, 24 + (4 if ver == 1 else 0), 8)
            root_addr = _u(buf, 24 + 32 + (4 if ver == 1 else 0) + 8, 8)
        else:
            if struct.unpack_from("<I", buf, 44)[0] != lookup3(
                    bytes(buf[:44])):
                raise FatalError(f"{path}: SUPERBLOCK VERSION {ver}: "
                                 "CHECKSUM MISMATCH")
            base, root_addr = _u(buf, 12, 8), _u(buf, 36, 8)
        if base:
            raise FatalError(f"{path}: BASE ADDRESS {base} (A USER BLOCK) "
                             "NOT SUPPORTED")
        root = _Object(self, root_addr)
        self._links = self._group_links(root)
        self._names = {a: name for name, a in self._links.items()}
        self.attrs = self._attrs(root)

    # -- groups --------------------------------------------------------------

    def _group_links(self, obj):
        """{name: object header address} of a group's hard links, in
        creation order where the group tracks it, else in name order (the
        order h5py iterates)."""
        path = self.path
        st = obj.find(0x11)
        if st:
            return self._symbol_table(*struct.unpack_from("<QQ", st[0][3]))
        linfo = obj.find(0x02)
        if not linfo:
            raise FatalError(f"{path}: GROUP WITHOUT LINK INFO OR SYMBOL "
                             "TABLE")
        li = linfo[0][3]
        tracked = bool(li[1] & 1)
        heap_at = 2 + (8 if tracked else 0)
        heap_addr, name_bt = struct.unpack_from("<QQ", li, heap_at)
        if heap_addr == UNDEF:
            msgs = [m for _, _, _, m in obj.find(0x06)]
        else:
            heap = _FractalHeap(self, heap_addr)
            btype, recs = _btree2_records(self, name_bt)
            if btype != 5:
                raise FatalError(f"{path}: LINK NAME INDEX OF B-TREE TYPE "
                                 f"{btype}")
            msgs = [heap.get(r[4:]) for r in recs]
        links = [self._link(m) for m in msgs]
        links.sort(key=lambda e: e[0] if tracked else e[1].encode())
        return {name: a for _, name, a in links}

    def _link(self, m):
        """(creation order, name, address) of a link message."""
        fl = m[1]
        p = 2
        ltype = 0
        if fl & 0x08:
            ltype, p = m[p], p + 1
        crt = 0
        if fl & 0x04:
            crt, p = struct.unpack_from("<Q", m, p)[0], p + 8
        if fl & 0x10:
            p += 1
        w = 1 << (fl & 3)
        n = int.from_bytes(m[p:p + w], "little")
        name = m[p + w:p + w + n].decode("utf-8")
        if ltype != 0:
            raise FatalError(f"{self.path}: LINK {name}: SOFT OR EXTERNAL "
                             "LINKS NOT SUPPORTED")
        return crt, name, struct.unpack_from("<Q", m, p + w + n)[0]

    def _symbol_table(self, btree, lheap):
        """An old-style group: the names (local heap) and object headers
        of its symbol table nodes, which its v1 B-tree keeps in name
        order."""
        buf = self._buf
        _signature(self, lheap, b"HEAP", "LOCAL HEAP")
        data = _u(buf, lheap + 24, 8)
        out = {}
        for _, snod in _btree1_entries(self, btree, 8):
            _signature(self, snod, b"SNOD", "SYMBOL TABLE NODE")
            for i in range(struct.unpack_from("<H", buf, snod + 6)[0]):
                e = snod + 8 + 40 * i
                at = data + _u(buf, e, 8)
                name = bytes(buf[at:buf.find(b"\0", at)]).decode("utf-8")
                out[name] = _u(buf, e + 8, 8)
        return out

    # -- attributes ----------------------------------------------------------

    def _attrs(self, obj):
        """{name: value} in creation order where tracked, else in name
        order; compact (attribute messages in the header) or dense (the
        attribute info message's fractal heap and v2 B-tree)."""
        tracked = obj.crt_tracked
        msgs = [(crt, m) for _, _, crt, m in obj.find(0x0C)]
        for _, _, _, m in obj.find(0x15):
            tracked = tracked or bool(m[1] & 1)
            heap_addr, name_bt = struct.unpack_from("<QQ", m,
                                                    4 if m[1] & 1 else 2)
            if heap_addr == UNDEF:
                continue
            heap = _FractalHeap(self, heap_addr)
            btype, recs = _btree2_records(self, name_bt)
            if btype != 8:
                raise FatalError(f"{self.path}: ATTRIBUTE NAME INDEX OF "
                                 f"B-TREE TYPE {btype}")
            for r in recs:
                if r[8] & 2:
                    raise FatalError(f"{self.path}: SHARED ATTRIBUTE NOT "
                                     "SUPPORTED")
                msgs.append((struct.unpack_from("<I", r, 9)[0],
                             heap.get(r[:8])))
        out = [(crt, *self._attr(m)) for crt, m in msgs]
        out.sort(key=lambda e: e[0] if tracked else e[1].encode())
        return {name: v for _, name, v in out}

    def _attr(self, m):
        """(name, value) of an attribute message of version 1, 2 or 3."""
        path = self.path
        ver = m[0]
        nsz, tsz, ssz = struct.unpack_from("<HHH", m, 2)
        if ver == 1:
            p = 8
            name = m[p:p + nsz].rstrip(b"\0").decode("utf-8")
            p += nsz + (-nsz % 8)
            tb = m[p:p + tsz]
            p += tsz + (-tsz % 8)
            sb = m[p:p + ssz]
            p += ssz + (-ssz % 8)
        elif ver in (2, 3):
            if m[1] & 3:
                raise FatalError(f"{path}: SHARED ATTRIBUTE DATATYPE "
                                 "OR DATASPACE NOT SUPPORTED")
            p = 8 + (1 if ver == 3 else 0)
            name = m[p:p + nsz].rstrip(b"\0").decode("utf-8")
            tb, sb = m[p + nsz:p + nsz + tsz], \
                m[p + nsz + tsz:p + nsz + tsz + ssz]
            p += nsz + tsz + ssz
        else:
            raise FatalError(f"{path}: ATTRIBUTE MESSAGE VERSION {ver}")
        dtype, _ = _decode_type(path, tb)
        return name, self._value(dtype, _decode_space(sb), m[p:])

    def _value(self, dtype, shape, data):
        if shape is None:
            return Empty(dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if isinstance(dtype, tuple) and dtype[0] == "vlen_str":
            # h5py gives str: a scalar as it is, an array as objects
            out = np.empty(n, object)
            for i in range(n):
                cnt, coll, idx = struct.unpack_from("<IQI", data, 16 * i)
                raw = self._heap_object(coll, idx)[:cnt] if cnt else b""
                out[i] = raw.decode("utf-8", "surrogateescape")
            return out[0] if not shape else out.reshape(shape)
        if isinstance(dtype, tuple):                 # vlen of references
            out = np.empty(n, object)
            for i in range(n):
                cnt, coll, idx = struct.unpack_from("<IQI", data, 16 * i)
                raw = self._heap_object(coll, idx) if cnt else b""
                out[i] = np.frombuffer(raw, dtype[1], count=cnt).copy()
            return out.reshape(shape)
        a = np.frombuffer(data, dtype, count=n)
        return a[0] if not shape else a.reshape(shape).copy()

    def _heap_object(self, coll, idx):
        """Object ``idx`` of the global heap collection at ``coll``
        (III.E); each collection is parsed once."""
        objs = self._gcols.get(coll)
        if objs is None:
            buf = self._buf
            _signature(self, coll, b"GCOL", "GLOBAL HEAP COLLECTION")
            size = struct.unpack_from("<Q", buf, coll + 8)[0]
            p, end, objs = coll + 16, coll + size, {}
            while p + 16 <= end:
                i, _, _, sz = struct.unpack_from("<HHIQ", buf, p)
                if i == 0:
                    break
                objs[i] = bytes(buf[p + 16:p + 16 + sz])
                p += 16 + sz + (-sz % 8)
            self._gcols[coll] = objs
        if idx not in objs:
            raise FatalError(f"{self.path}: GLOBAL HEAP {coll} HAS NO "
                             f"OBJECT {idx}")
        return objs[idx]

    # -- h5py's interface ----------------------------------------------------

    def _by_addr(self, addr):
        name = self._names.get(int(addr))
        if name is None:
            raise FatalError(f"{self.path}: REFERENCE TO AN OBJECT AT "
                             f"{addr} OUTSIDE THE ROOT GROUP")
        return self[name]

    def __contains__(self, name):
        return name in self._links

    def __getitem__(self, name):
        ds = self._objs.get(name)
        if ds is None:
            obj = _Object(self, self._links[name])
            if not (obj.find(0x01) and obj.find(0x08)):
                raise FatalError(f"{self.path}: {name}: A GROUP OR NAMED "
                                 "DATATYPE IN THE ROOT GROUP NOT SUPPORTED")
            ds = self._objs[name] = _RDataset(self, name, obj)
        return ds

    def items(self):
        return [(name, self[name]) for name in self._links]

    def close(self):
        self._buf.close()
        self._fh.close()


def open_file(path: str, mode: str = "r"):
    """The port's HDF5 file: ``"w"``, ``"w-"`` or ``"x"`` encodes, ``"r"``
    parses."""
    if mode in ("w", "w-", "x"):
        return _Writer(path, mode)
    if mode == "r":
        return _Reader(path)
    raise FatalError(f"{path}: MODE {mode!r}: the port's HDF5 file is "
                     "written once or read")
