"""Packed ELL apply with the slab gather inside the kernel: the Hopper
kernel and its plain twin.

Counterpart of ``mpassit_tpu/ops/pallas_matmul.py::
fused_apply_packed_gather``. No slab array is formed: row ``r`` of tile
``t``'s slab (a ``loc8`` value of the chunked-run layout,
``ops/matmul_apply._chunk_slab``) is source row
``ch_src[t, r // 8] * 8 + r % 8`` of ``src`` (n_src + 8, Cp), the 8 extra
rows letting the last chunk of a run read past ``n_src``. Everything else
is ``packed_apply``'s function (f32 sums, the Q4 rotation, tail zeros,
the checksum): on the same operator the two agree bit for bit, kernel
against kernel (one CUDA template, ``csrc/ell_apply.cuh``) and plain
against plain.

As for ``packed_apply``, the TPU kernel's ``precision`` has no
counterpart. ``packed_gather_apply`` launches ``csrc/packed_gather.cu``
for CUDA tensors and runs ``packed_gather_apply_plain`` for CPU tensors;
there is no fallback from one to the other.
"""

from __future__ import annotations

import os
import threading

import torch

from . import _build
from ._build import ints, ptr, ptrs
from .packed_kernel import (
    _aligned,
    _check_ell,
    _check_layout,
    _ell_row,
    _outputs,
    _plain_rows,
    _route,
    _stream,
    plan_on,
)

#: source rows per chunk of the chunked-run layout (matmul_apply._chunk_slab)
CH = 8

#: kernel launches by ``packed_gather_apply``
LAUNCHES = 0
#: calls of ``packed_gather_apply_plain``
PLAIN_CALLS = 0

SOURCE = os.path.join(_build.CSRC, "packed_gather.cu")
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib = None
#: what the last build did: {"so", "seconds", "log"}
BUILD_INFO: dict = {}

_P, _I, _IP, _PP = _build.P, _build.I, _build.IP, _build.PP
_ARGTYPES = [_P, _P, _I, _P, _PP, _PP, _IP, _I, _P, _I, _P, _P, _P, _P, _I,
             _I, _I, _I, _I, _I, _P]


def build():
    """Compile ``csrc/packed_gather.cu`` (once per source content) and
    load it. Returns the ctypes library; raises on a failed build or
    load."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, BUILD_DIR,
                               {"packed_gather_launch": _ARGTYPES},
                               BUILD_INFO)
        return _lib


def _check_args(src, ch_src, locs, ws, W8, ranges, nty, ntx, rotate, cosa,
                sina):
    if src.dim() != 2 or src.dtype != torch.float32:
        raise ValueError("src must be a (n_src + 8, Cp) float32 tensor")
    if ch_src.dim() != 2 or ch_src.dtype != torch.int32:
        raise ValueError("ch_src must be (n_tiles, NC) int32")
    n_tiles, NC = ch_src.shape
    if W8 != NC * CH:
        raise ValueError(f"W8 {W8} != NC*CH {NC * CH}")
    _check_layout(n_tiles, src.shape[1], ranges, nty, ntx, rotate, cosa,
                  sina)
    _check_ell(locs, ws, n_tiles, len(ranges))


def packed_gather_apply(src, ch_src, locs, ws, *, W8, ranges, nty, ntx,
                        rotate=(), cosa=None, sina=None,
                        with_checksum=False):
    """src (n_src + 8, Cp) f32, Cp % 128 == 0; ch_src (n_tiles, NC) int32
    chunk starts divided by 8; locs/ws: one (n_tiles, K_m, 1024)
    int32/f32 pair per method in the W8 = 8*NC chunk-layout index space;
    ranges, rotate, cosa/sina and the outputs as for
    ops/packed_kernel.packed_apply."""
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_args(src, ch_src, locs, ws, W8, ranges, nty, ntx, rotate, cosa,
                sina)
    dev = src.device
    if not _route("packed_gather_apply", dev,
                  [ch_src, *locs, *ws, cosa, sina]):
        return packed_gather_apply_plain(
            src, ch_src, locs, ws, W8=W8, ranges=ranges, nty=nty, ntx=ntx,
            rotate=rotate, cosa=cosa, sina=sina, with_checksum=with_checksum)
    src, ch_src, *locs = _aligned([src, ch_src, *locs])
    ws = _aligned(ws)
    if rotate:
        cosa, sina = _aligned([cosa, sina])
    n_tiles, NC = ch_src.shape
    Cp = src.shape[1]
    plan, table = plan_on(dev, n_tiles, W8, Cp, ranges, rotate)
    lib = build()
    out, partial, checksum = _outputs(dev, n_tiles, nty, ntx, Cp, plan.nblk,
                                      with_checksum)
    with torch.cuda.device(dev):
        rc = lib.packed_gather_launch(
            src.data_ptr(), ch_src.data_ptr(), NC, out.data_ptr(),
            ptrs(locs), ptrs(ws), ints([a.shape[1] for a in locs]),
            len(ranges), table.data_ptr(), len(rotate),
            ptr(cosa if rotate else None), ptr(sina if rotate else None),
            ptr(partial), ptr(checksum), n_tiles, ntx, Cp, plan.cend,
            plan.BW, plan.min_blocks, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"packed_gather_launch failed: rc={rc}")
    global LAUNCHES
    LAUNCHES += 1
    if with_checksum:
        return out, checksum
    return out


def packed_gather_apply_plain(src, ch_src, locs, ws, *, W8, ranges, nty, ntx,
                              rotate=(), cosa=None, sina=None,
                              with_checksum=False):
    """``packed_gather_apply`` in plain PyTorch, on any device: per tile
    row, the chunked rows of ``src`` become the row's (ntx, W8, Cp) slab,
    then ``packed_apply_plain``'s K-term sums and epilogue."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_args(src, ch_src, locs, ws, W8, ranges, nty, ntx, rotate, cosa,
                sina)
    Cp = src.shape[1]
    lane = torch.arange(CH, device=src.device)

    def row_block(i):
        t0, t1 = i * ntx, (i + 1) * ntx
        rows = (ch_src[t0:t1].long()[:, :, None] * CH + lane).reshape(
            ntx, W8)
        return _ell_row(src[rows], locs, ws, ranges, t0, t1, Cp)

    return _plain_rows(row_block, nty=nty, ntx=ntx, Cp=Cp, dev=src.device,
                       rotate=rotate, cosa=cosa, sina=sina,
                       with_checksum=with_checksum)
