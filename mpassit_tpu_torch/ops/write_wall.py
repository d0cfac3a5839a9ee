"""Store-only write probe: the Hopper kernel and its plain twin.

Counterpart of the TPU kernel of ``bench.py::make_write_wall``: the
``(nty*32, ntx*32, Cp)`` f32 output of an apply with every row equal to
``seed[0, 0, :]``. Its time on the card is the device-memory write ceiling
at that exact output shape, the roofline of the apply kernels, which write
the same array.

``write_wall`` launches ``csrc/write_wall.cu`` for a CUDA tensor and runs
``write_wall_plain`` for a CPU tensor; any other device raises. There is no
fallback from one to the other; a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from . import _build
from .packed_kernel import TX, TY, _route, _stream

#: kernel launches by ``write_wall`` (one per call on a CUDA tensor)
LAUNCHES = 0
#: calls of ``write_wall_plain``
PLAIN_CALLS = 0

SOURCE = os.path.join(_build.CSRC, "write_wall.cu")
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib = None
#: what the last build did: {"so", "seconds", "log"}
BUILD_INFO: dict = {}

_ARGTYPES = [_build.P, _build.P, ctypes.c_longlong, _build.I, _build.P]


def build():
    """Compile ``csrc/write_wall.cu`` (once per source content) and load
    it. Returns the ctypes library; raises on a failed build or load."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, BUILD_DIR,
                               {"write_wall_launch": _ARGTYPES}, BUILD_INFO)
        return _lib


def _check(seed, nty, ntx):
    if (seed.dim() != 3 or seed.shape[:2] != (1, 1)
            or seed.dtype != torch.float32):
        raise ValueError("seed must be a (1, 1, Cp) float32 tensor")
    Cp = seed.shape[2]
    if Cp < 4 or Cp % 4:
        raise ValueError(f"Cp {Cp} must be a positive multiple of 4")
    if nty < 1 or ntx < 1:
        raise ValueError(f"grid ({nty}, {ntx}) must be at least (1, 1)")
    return Cp


def write_wall(seed, *, nty, ntx):
    """seed (1, 1, Cp) f32, Cp % 4 == 0. Returns (nty*32, ntx*32, Cp) f32
    with every row equal to ``seed[0, 0]`` (the contract of
    bench.make_write_wall's kernel), every element stored once."""
    Cp = _check(seed, nty, ntx)
    dev = seed.device
    if not _route("write_wall", dev, []):
        return write_wall_plain(seed, nty=nty, ntx=ntx)
    seed = seed.contiguous()
    lib = build()
    out = torch.empty((nty * TY, ntx * TX, Cp), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        rc = lib.write_wall_launch(seed.data_ptr(), out.data_ptr(),
                                   nty * TY * ntx * TX, Cp, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"write_wall_launch failed: rc={rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def write_wall_plain(seed, *, nty, ntx):
    """``write_wall`` in plain PyTorch, on any device."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    Cp = _check(seed, nty, ntx)
    return seed.reshape(1, 1, Cp).expand(nty * TY, ntx * TX, Cp).clone()
