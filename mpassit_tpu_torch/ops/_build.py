"""Build and load a hand-written CUDA source of ``csrc/`` as a shared
library with a plain C interface.

``load(source, build_dir, symbols, info)`` compiles ``source`` with
``nvcc`` for sm_90a into ``build_dir`` (once per content of the source, of
the headers beside it and of the flags) and loads it with ctypes, setting
each exported function's argument types. A failed build or load raises;
nothing falls back to another route.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_PKG = os.path.dirname(_HERE)
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v"]

P, I = ctypes.c_void_p, ctypes.c_int
IP = ctypes.POINTER(ctypes.c_int)
PP = ctypes.POINTER(ctypes.c_void_p)


def nvcc(source: str) -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build "
                           f"{source}")
    return path


def _digest(source: str) -> str:
    """Content key: the source, every header of its directory, the flags."""
    h = hashlib.sha256()
    for path in [source] + sorted(glob.glob(os.path.join(
            os.path.dirname(source), "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(source: str, build_dir: str, symbols: dict, info: dict):
    """Compile ``source`` if its content-keyed library is not built yet,
    load it, and give each function named in ``symbols`` its ctypes
    ``argtypes`` (restype int). ``info`` receives {"so", "seconds",
    "log"}; seconds is None when an already-built library was loaded."""
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(build_dir, f"lib{stem}_{_digest(source)}.so")
    seconds, log = None, ""
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        cmd = [nvcc(source), *NVCC_FLAGS, "-o", tmp, source]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in symbols.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = I
    info.update(so=so, seconds=seconds, log=log)
    return lib


def ints(vals):
    return (ctypes.c_int * max(len(vals), 1))(*vals)


def ptrs(ts):
    return (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])


def ptr(t):
    return None if t is None else t.data_ptr()
