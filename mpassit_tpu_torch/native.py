"""On-demand build + ctypes loader for the native (C++) weight-gen kernels.

The reference's native surface is external C++ (ESMF's mesh search and
clipping, SURVEY §2.3); ours is ``csrc/regrid_native.cpp``, compiled once
with g++ into the ignored ``_build/`` directory of this package and loaded
through ctypes. Everything
degrades gracefully to the vectorized NumPy implementations when no
compiler is available (set MPASSIT_NO_NATIVE=1 to force the fallback).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("mpassit_tpu_torch")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "regrid_native.cpp")
_SO = os.path.join(_HERE, "_build", "_regrid_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    tmp = f"{_SO}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception as e:  # compiler missing, build error, ...
        log.info("native build skipped: %s", e)
        return False


def get_lib():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MPASSIT_NO_NATIVE") == "1":
            return None
        if not os.path.exists(_SO) or (
            os.path.exists(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_SO)
        ):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError as e:
            log.info("native load failed: %s", e)
            return None
        lib.clip_pairs.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.clip_pairs.restype = None
        lib.conservative_pairs.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.conservative_pairs.restype = None
        lib.bary_locate.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.bary_locate.restype = None
        _lib = lib
        return _lib


def clip_pairs(quad: np.ndarray, spoly: np.ndarray, scnt: np.ndarray):
    """Intersection areas for (target-quad, source-polygon) pairs, or None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n, vmax = spoly.shape[0], spoly.shape[1]
    quad = np.ascontiguousarray(quad, dtype=np.float64)
    spoly = np.ascontiguousarray(spoly, dtype=np.float64)
    scnt = np.ascontiguousarray(scnt, dtype=np.int32)
    out = np.empty(n, dtype=np.float64)
    lib.clip_pairs(n, vmax, quad, spoly, scnt, out)
    return out


def conservative_pairs(pt, ps, ctr, e1, e2, corners, voc, vxyz):
    """Overlap fractions for (target, source) candidate pairs — the whole
    per-pair conservative pipeline in one OpenMP pass — or None when the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pt = np.ascontiguousarray(pt, dtype=np.int64)
    ps = np.ascontiguousarray(ps, dtype=np.int64)
    ctr = np.ascontiguousarray(ctr, dtype=np.float64)
    e1 = np.ascontiguousarray(e1, dtype=np.float64)
    e2 = np.ascontiguousarray(e2, dtype=np.float64)
    corners = np.ascontiguousarray(corners, dtype=np.float64)
    voc = np.ascontiguousarray(voc, dtype=np.int64)
    vxyz = np.ascontiguousarray(vxyz, dtype=np.float64)
    frac = np.empty(len(pt), dtype=np.float64)
    lib.conservative_pairs(len(pt), voc.shape[1], pt, ps, ctr, e1, e2,
                           corners, voc, vxyz, frac)
    return frac


def bary_locate(points: np.ndarray, cand: np.ndarray, tri_verts: np.ndarray):
    """Best containing-triangle slot + barycentric weights per point, or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n, ntri = cand.shape
    points = np.ascontiguousarray(points, dtype=np.float64)
    cand = np.ascontiguousarray(cand, dtype=np.int64)
    tri_verts = np.ascontiguousarray(tri_verts, dtype=np.float64)
    best = np.empty(n, dtype=np.int64)
    w = np.empty((n, 3), dtype=np.float64)
    lib.bary_locate(n, ntri, points, cand, tri_verts, best, w)
    return best, w
