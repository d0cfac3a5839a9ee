"""Decoders of the HDF5 filters beyond deflate, shuffle and Fletcher32 that
h5py reads, for the port's HDF5 reader (``io/hdf5.py``): szip (4), n-bit
(5), scale-offset (6) and LZF (32000).

- szip and LZF are loops over single bits and bytes, which Python cannot
  run at the sizes of real inputs. They are C++
  (``csrc/h5_filters.cpp``), built with ``g++ -O3`` at their first use
  into the ignored ``_build/`` directory of this package (a file named by
  the source's content, written under a name of its own per process,
  then moved into place), and loaded with ctypes. A failed build raises
  ``FatalError``: there is no Python decoder to fall back to.
- scale-offset and n-bit unpack fixed-width fields from an MSB-first bit
  stream: ``np.unpackbits`` and one shift-and-add per field bit do that
  at numpy's speed, so they stay in numpy.

Each decoder follows the library that writes the format: libaec's
``SZ_BufftoBuffDecompress`` behind HDF5's ``H5Zszip.c``, h5py's
``lzf_filter.c`` on liblzf, HDF5's ``H5Zscaleoffset.c`` and
``H5Znbit.c``. Each takes the raw bytes, the filter's client data, the
chunk's name (``where``) and ``limit``, the most bytes the filters
applied before it when writing can have made of the chunk's elements: a
chunk that would decode to more is corrupt and refused before anything
is allocated. A decode error raises ``FatalError`` naming the filter and
the chunk.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..errors import FatalError

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
SOURCE = os.path.join(_PKG, "csrc", "h5_filters.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    """Where the build of the current source lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"_h5_filters_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``csrc/h5_filters.cpp`` unless its build exists; returns the
    library's path. Raises ``FatalError`` when g++ is missing or fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise FatalError(f"BUILDING THE HDF5 FILTER DECODERS ({SOURCE}): "
                         f"g++ DID NOT RUN: {e}") from e
    if proc.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise FatalError(f"BUILDING THE HDF5 FILTER DECODERS ({SOURCE}): "
                         f"g++ EXITED {proc.returncode}: "
                         f"{proc.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


def lib():
    """The loaded decoder library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            so = build()
            try:
                handle = ctypes.CDLL(so)
            except OSError as e:
                raise FatalError(f"LOADING THE HDF5 FILTER DECODERS ({so}): "
                                 f"{e}") from e
            p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            handle.h5_lzf_decode.argtypes = [p, i64, p, i64]
            handle.h5_lzf_decode.restype = i64
            handle.h5_szip_decode.argtypes = [p, i64, p, i64, i, i, i, i]
            handle.h5_szip_decode.restype = i64
            _lib = handle
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


_ERRORS = {-1: "THE OUTPUT OVERRUNS ITS BUFFER",
           -2: "A BACK-REFERENCE BEFORE THE START OF THE OUTPUT",
           -3: "THE INPUT ENDS INSIDE A RUN",
           -4: "A SECOND-EXTENSION CODE PAST ITS TABLE",
           -5: "PARAMETERS OUT OF RANGE",
           -6: "THE CODED STREAM ENDS EARLY (A TRUNCATED CHUNK)",
           -7: "A ZERO-BLOCK RUN PAST ITS REFERENCE SAMPLE INTERVAL",
           -8: "OUT OF MEMORY"}


def _too_large(where, name, limit, n=None):
    size = "" if n is None else f"{n} BYTES, "
    raise FatalError(f"{where}: FILTER {name}: THE CHUNK DECODES TO {size}"
                     f"MORE THAN THE {limit} BYTES ITS ELEMENTS CAN MAKE "
                     "(A CORRUPT CHUNK)")


# ---- LZF (32000) -----------------------------------------------------------

def lzf(raw, cd, where: str, limit: int) -> bytes:
    """h5py's lzf_filter: cd[2], where given, is the chunk's bytes; the
    output buffer grows by the input's size while it is too small, up to
    ``limit``."""
    src = np.frombuffer(raw, np.uint8)
    grow = max(len(src), 1)
    size = min(cd[2] if len(cd) >= 3 and cd[2] else grow, limit)
    decode = lib().h5_lzf_decode
    while True:
        out = np.empty(size, np.uint8)
        n = decode(_ptr(src), len(src), _ptr(out), size)
        if n != -1:
            break
        if size == limit:
            _too_large(where, "32000 (LZF)", limit)
        size = min(size + grow, limit)
    if n < 0:
        raise FatalError(f"{where}: FILTER 32000 (LZF): {_ERRORS[n]}")
    return out[:n].tobytes()


# ---- szip (4) --------------------------------------------------------------

def szip(raw, cd, where: str, limit: int) -> bytes:
    """H5Zszip: client data (options mask, pixels per block, bits per
    pixel, pixels per scanline); the chunk is its decoded size (4 bytes,
    little-endian), then the coded stream."""
    if len(cd) < 4:
        raise FatalError(f"{where}: FILTER 4 (SZIP): {len(cd)} CLIENT DATA "
                         "VALUES, NOT 4")
    mask, ppb, bpp, pps = cd[:4]
    if len(raw) < 4:
        raise FatalError(f"{where}: FILTER 4 (SZIP): A CHUNK OF "
                         f"{len(raw)} BYTES")
    want = int.from_bytes(bytes(raw[:4]), "little")
    if want > limit:
        _too_large(where, "4 (SZIP)", limit, want)
    src = np.frombuffer(raw, np.uint8, offset=4)
    out = np.empty(want, np.uint8)
    n = lib().h5_szip_decode(_ptr(src), len(src), _ptr(out), want,
                             mask, ppb, bpp, pps)
    if n < 0:
        raise FatalError(f"{where}: FILTER 4 (SZIP): {_ERRORS[n]}")
    if n != want:
        raise FatalError(f"{where}: FILTER 4 (SZIP): THE CODED STREAM ENDS "
                         f"AFTER {n} OF {want} BYTES (A TRUNCATED CHUNK)")
    return out.tobytes()


# ---- the MSB-first bit fields of scale-offset and n-bit --------------------

def _fields(raw, count: int, bits: int, where: str, name: str):
    """``count`` unsigned fields of ``bits`` bits each (1-64), packed
    MSB first, as uint64."""
    need = -(-count * bits // 8)
    if len(raw) < need:
        raise FatalError(f"{where}: FILTER {name}: {len(raw)} BYTES HOLD "
                         f"FEWER THAN {count} FIELDS OF {bits} BITS")
    b = np.unpackbits(np.frombuffer(raw, np.uint8, count=need),
                      count=count * bits).reshape(count, bits)
    out = np.zeros(count, np.uint64)
    for j in range(bits):
        out = (out << np.uint64(1)) | b[:, j]
    return out


def _native(values: np.ndarray, size: int, signed: bool, order: int):
    """uint64 values as integers of ``size`` bytes (two's complement
    wrap), in the byte order ``order`` (0 little, 1 big)."""
    kind = "i" if signed else "u"
    out = values.astype(f"<u{size}").view(f"<{kind}{size}")
    return out.astype(f"{'>' if order else '<'}{kind}{size}")


# ---- scale-offset (6) ------------------------------------------------------

_SO_HEADER = 21          # minbits (4), minval's size (1), minval, padding


def scale_offset(raw, cd, where: str, limit: int) -> bytes:
    """H5Zscaleoffset's decompression: client data (scale type, scale
    factor, elements, class, size, sign, order, fill value defined,
    fill value bytes); a chunk is minbits and minval, then the elements'
    offsets from minval in minbits bits each (all ones: the fill value),
    integers as they are, floats (D-scale) over 10**factor."""
    name = "6 (SCALE-OFFSET)"
    if len(cd) < 8:
        raise FatalError(f"{where}: FILTER {name}: {len(cd)} CLIENT DATA "
                         "VALUES")
    scale_type, factor, nelmts, cls, size, sign, order, filavail = cd[:8]
    if cls not in (0, 1) or size not in (1, 2, 4, 8) or (
            cls == 1 and size not in (4, 8)):
        raise FatalError(f"{where}: FILTER {name}: CLASS {cls} OF {size} "
                         "BYTES NOT SUPPORTED")
    if cls == 1 and scale_type != 0:
        raise FatalError(f"{where}: FILTER {name}: SCALE TYPE {scale_type} "
                         "(E-SCALE) NOT SUPPORTED")
    raw = bytes(raw)
    if len(raw) < _SO_HEADER:
        raise FatalError(f"{where}: FILTER {name}: A CHUNK OF {len(raw)} "
                         "BYTES")
    minbits = int.from_bytes(raw[:4], "little")
    msize = min(raw[4], 8)
    minval = int.from_bytes(raw[5:5 + msize], "little")
    if minbits > 8 * size:
        raise FatalError(f"{where}: FILTER {name}: MINBITS {minbits} FOR "
                         f"{size}-BYTE ELEMENTS")
    nbytes = nelmts * size
    if nbytes > limit:
        _too_large(where, name, limit, nbytes)
    dt = np.dtype(f"{'>' if order else '<'}{'f' if cls else 'iu'[1 - sign]}"
                  f"{size}")
    if minbits == 8 * size:                 # stored as they are
        if len(raw) < _SO_HEADER + nbytes:
            raise FatalError(f"{where}: FILTER {name}: {len(raw)} BYTES "
                             f"HOLD FEWER THAN {nelmts} ELEMENTS")
        out = np.frombuffer(raw, "<u1", count=nbytes, offset=_SO_HEADER)
        return out.view(dt.newbyteorder("<")).astype(dt).tobytes()
    if minbits:
        v = _fields(raw[_SO_HEADER:], nelmts, minbits, where, name)
    else:
        v = np.zeros(nelmts, np.uint64)
    fill_mask = np.uint64((1 << minbits) - 1)
    fill = None
    if filavail == 1:
        words = np.asarray(cd[8:8 + -(-size // 4)], "<u4").tobytes()
        fill = np.frombuffer(words[:size], dt.newbyteorder("<"))[0]
    if cls == 0:
        vals = _native(v + np.uint64(minval & ((1 << 64) - 1)), size,
                       sign == 1, 0)
        if fill is not None:
            vals = np.where(v == fill_mask, fill, vals).astype(vals.dtype)
        return vals.astype(dt).tobytes()
    # D-scale: the field as a signed integer of the type's size, over
    # 10**factor, plus min: arithmetic in the float type (powf for f4)
    ftype = np.dtype(f"<f{size}")
    fmin = np.frombuffer(minval.to_bytes(8, "little")[:size], ftype)[0]
    factor = factor - (1 << 32) if factor >= 1 << 31 else factor
    vals = (_native(v, size, True, 0).astype(ftype)
            / ftype.type(10.0 ** factor) + fmin).astype(ftype)
    if fill is not None:
        vals = np.where(v == fill_mask, fill, vals).astype(ftype)
    return vals.astype(dt).tobytes()


# ---- n-bit (5) -------------------------------------------------------------

_NBIT_CLASS = {1: "ATOMIC", 2: "ARRAY", 3: "COMPOUND", 4: "NO-OP"}


def nbit(raw, cd, where: str, limit: int) -> bytes:
    """H5Znbit's decompression of an integer or floating-point dataset:
    client data (parameter count, need-not-compress flag, elements, class
    1, size, order, precision, offset); each element's ``precision`` bits
    packed MSB first, put back at bit ``offset`` with the other bits 0.
    A full-precision type is stored as it is (the flag)."""
    name = "5 (N-BIT)"
    if len(cd) < 4:
        raise FatalError(f"{where}: FILTER {name}: {len(cd)} CLIENT DATA "
                         "VALUES")
    if cd[1]:
        return bytes(raw)
    cls = cd[3]
    if cls != 1 or len(cd) < 8:
        raise FatalError(f"{where}: FILTER {name}: "
                         f"{_NBIT_CLASS.get(cls, f'CLASS {cls}')} DATATYPE "
                         f"({len(cd)} CLIENT DATA VALUES) NOT SUPPORTED")
    nelmts, size, order, precision, offset = cd[2], *cd[4:8]
    if size not in (1, 2, 4, 8) or not 0 < precision <= 8 * size - offset:
        raise FatalError(f"{where}: FILTER {name}: PRECISION {precision} AT "
                         f"OFFSET {offset} IN {size} BYTES")
    if nelmts * size > limit:
        _too_large(where, name, limit, nelmts * size)
    v = _fields(raw, nelmts, precision, where, name) << np.uint64(offset)
    return _native(v, size, False, order).tobytes()
