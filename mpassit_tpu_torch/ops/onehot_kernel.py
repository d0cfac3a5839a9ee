"""One-hot-operator apply: the Hopper kernel, its plain twins and the bf16
split helpers.

Counterpart of the two TPU kernels of ``mpassit_tpu/ops/pallas_matmul.py``
that take a one-hot operator ``A`` (``matmul_apply._build_A_T``):

- ``onehot_apply`` for ``fused_apply`` (single method): ``A[t]^T @ slab[t]``
  written into the row-major ``(nty*32, ntx*32, Cp)`` target layout;
- ``onehot_apply_packed`` for ``fused_apply_packed`` with ``As=``: one
  ``A`` per method column range over one union slab, then the Q4 rotation,
  tail zeros and the optional per-tile checksum, as ``packed_apply``.

``A`` is ``(n_tiles, W, 1024)`` f32 here. The TPU takes it prestacked into
3 or 6 bf16 copies (``_prep_A``); the CUDA kernel (``csrc/onehot_apply.cu``)
and the plain versions split both operands themselves and compute the same
term set per ``precision``:

    highest:      A @ S in f32
    split_bf16:   Ah Sh + Ah Sl + Al Sh                    (_stack_A/_stack_S)
    split6_bf16:  A0S0 + A0S1 + A1S0 + A0S2 + A1S1 + A2S0  (_stack_A6/_stack_S6)

with ``hi = bf16_rn(x)``, ``lo = bf16_rn(x - hi)`` and the three-way parts
of ``_split_3way``. A product of two bf16 values is exact in f32, so only
the order of the f32 sums differs between the kernel, the plain version
and the TPU. The plain versions (``_tile_matmul`` on the stacked operands,
per tile row, then the shared epilogue of ops/packed_kernel.py) need full
f32 matrix products: ``torch.backends.cuda.matmul.allow_tf32`` False, the
default, on a card.

Each wrapper launches the kernel for CUDA tensors and runs its plain
version for CPU tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import os
import threading

import torch

from . import _build
from ._build import ints, ptr, ptrs
from .packed_kernel import (
    LANE,
    MAX_METHODS,
    MAX_WINDOWS,
    TILE,
    _check_layout,
    _outputs,
    _plain_rows,
    _route,
    _stream,
)

#: precision -> the kernel's term set (0 highest, 1 split_bf16, 2 split6)
PRECISION_CODE = {"highest": 0, "split_bf16": 1, "split6_bf16": 2}
PB = 32             # target points per block in csrc/onehot_apply.cu

#: kernel launches per wrapper (one per call on a CUDA tensor)
LAUNCHES = {"onehot_apply": 0, "onehot_apply_packed": 0}
#: calls of each plain version
PLAIN_CALLS = {"onehot_apply": 0, "onehot_apply_packed": 0}

SOURCE = os.path.join(_build.CSRC, "onehot_apply.cu")
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib = None
#: what the last build did: {"so", "seconds", "log"}
BUILD_INFO: dict = {}

_P, _I, _IP, _PP = _build.P, _build.I, _build.IP, _build.PP
_ARGTYPES = [_P, _P, _PP, _IP, _IP, _I, _IP, _IP, _IP, _I, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _P]


def build():
    """Compile ``csrc/onehot_apply.cu`` (once per source content) and load
    it. Returns the ctypes library; raises on a failed build or load."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, BUILD_DIR,
                               {"onehot_apply_launch": _ARGTYPES}, BUILD_INFO)
        return _lib


# ------------------------------------------------------- split helpers ----

def _split_hilo(x):
    """f32 -> (hi, lo) bf16 pair with x ~= hi + lo, each rounded to
    nearest-even (matmul_apply._split_hilo)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def _split_3way(x):
    """f32 -> (b0, b1, b2) bf16 triple with x ~= b0 + b1 + b2
    (matmul_apply._split_3way)."""
    b0 = x.to(torch.bfloat16)
    r1 = x - b0.float()
    b1 = r1.to(torch.bfloat16)
    b2 = (r1 - b1.float()).to(torch.bfloat16)
    return b0, b1, b2


def _stack_A(A, axis):
    """A -> (Ah, Ah, Al) stacked bf16; pairs with _stack_S."""
    hi, lo = _split_hilo(A)
    return torch.cat([hi, hi, lo], dim=axis)


def _stack_S(S, axis):
    """S -> (Sh, Sl, Sh) stacked bf16."""
    hi, lo = _split_hilo(S)
    return torch.cat([hi, lo, hi], dim=axis)


def _stack_A6(A, axis):
    """A -> (A0, A0, A1, A0, A1, A2) stacked bf16; pairs with _stack_S6."""
    a0, a1, a2 = _split_3way(A)
    return torch.cat([a0, a0, a1, a0, a1, a2], dim=axis)


def _stack_S6(S, axis):
    """S -> (S0, S1, S0, S2, S1, S0) stacked bf16."""
    s0, s1, s2 = _split_3way(S)
    return torch.cat([s0, s1, s0, s2, s1, s0], dim=axis)


def _prep_A(A, precision):
    """f32 A -> the operand the TPU kernels stream: stacked bf16 for the
    split modes, f32 for highest (matmul_apply._prep_A)."""
    if precision == "split_bf16":
        return _stack_A(A, 1)
    if precision == "split6_bf16":
        return _stack_A6(A, 1)
    return A.float()


def _tile_matmul(A, slab, precision):
    """Batched per-tile product (n_tiles, TILE, C) of a prepped A
    (``_prep_A``) and an f32 slab, split to match (matmul_apply
    ._tile_matmul); the bf16 values are multiplied and summed in f32."""
    if precision == "split_bf16":
        slab = _stack_S(slab, 1)
    elif precision == "split6_bf16":
        slab = _stack_S6(slab, 1)
    return torch.bmm(A.float().transpose(1, 2), slab.float())


# ------------------------------------------------------------ wrappers ----

def _check_onehot(As, slab, precision):
    if precision not in PRECISION_CODE:
        raise ValueError(f"precision must be one of {tuple(PRECISION_CODE)}")
    if slab.dim() != 3 or slab.dtype != torch.float32:
        raise ValueError("slab must be a (n_tiles, W, Cp) float32 tensor")
    n_tiles, W, _ = slab.shape
    for A in As:
        if A.shape != (n_tiles, W, TILE) or A.dtype != torch.float32:
            raise ValueError(
                f"A must be (n_tiles, W, 1024) = {(n_tiles, W, TILE)} f32, "
                f"got {tuple(A.shape)} {A.dtype}")


def _launch(name, As, slab, ranges, nty, ntx, precision, rotate, cosa, sina,
            with_checksum):
    nm, nr = len(ranges), len(rotate)
    if nm > MAX_METHODS or nr > MAX_WINDOWS:
        raise ValueError(f"at most {MAX_METHODS} ranges and {MAX_WINDOWS} "
                         f"rotate windows per launch")
    dev = slab.device
    slab = slab.contiguous()
    As = [A.contiguous() for A in As]
    if rotate:
        cosa, sina = cosa.contiguous(), sina.contiguous()
    lib = build()
    n_tiles, W, Cp = slab.shape
    out, partial, checksum = _outputs(dev, n_tiles, nty, ntx, Cp,
                                      Cp // LANE * (TILE // PB),
                                      with_checksum)
    with torch.cuda.device(dev):
        rc = lib.onehot_apply_launch(
            slab.data_ptr(), out.data_ptr(), ptrs(As),
            ints([r[0] for r in ranges]), ints([r[1] for r in ranges]), nm,
            ints([r[0] for r in rotate]), ints([r[1] for r in rotate]),
            ints([r[2] for r in rotate]), nr,
            ptr(cosa if rotate else None), ptr(sina if rotate else None),
            ptr(partial), ptr(checksum), n_tiles, ntx, W, Cp,
            PRECISION_CODE[precision], _stream(dev))
    if rc != 0:
        raise RuntimeError(f"onehot_apply_launch failed: rc={rc}")
    LAUNCHES[name] += 1
    if with_checksum:
        return out, checksum
    return out


def onehot_apply(A, slab, *, nty, ntx, precision="split_bf16"):
    """A (n_tiles, W, 1024) f32 one-hot operator, slab (n_tiles, W, Cp)
    f32 with Cp % 128 == 0. Returns (nty*32, ntx*32, Cp) f32 in row-major
    target layout: the single-method product with the term set of
    ``precision`` (the contract of pallas_matmul.fused_apply)."""
    _check_onehot((A,), slab, precision)
    n_tiles, _, Cp = slab.shape
    _check_layout(n_tiles, Cp, ((0, Cp),), nty, ntx, (), None, None)
    if not _route("onehot_apply", slab.device, [A]):
        return onehot_apply_plain(A, slab, nty=nty, ntx=ntx,
                                  precision=precision)
    return _launch("onehot_apply", (A,), slab, ((0, Cp),), nty, ntx,
                   precision, (), None, None, False)


def onehot_apply_packed(As, slab, *, ranges, nty, ntx,
                        precision="split_bf16", with_checksum=False,
                        rotate=(), cosa=None, sina=None):
    """As: one (n_tiles, W, 1024) f32 one-hot operator per method over the
    union slab (n_tiles, W, Cp); ranges, rotate, cosa/sina and the outputs
    as for ops/packed_kernel.packed_apply (the contract of
    pallas_matmul.fused_apply_packed with As=)."""
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_onehot(As, slab, precision)
    n_tiles, _, Cp = slab.shape
    _check_layout(n_tiles, Cp, ranges, nty, ntx, rotate, cosa, sina)
    if len(As) != len(ranges):
        raise ValueError("one A per range is required")
    if not _route("onehot_apply_packed", slab.device, [*As, cosa, sina]):
        return onehot_apply_packed_plain(
            As, slab, ranges=ranges, nty=nty, ntx=ntx, precision=precision,
            with_checksum=with_checksum, rotate=rotate, cosa=cosa, sina=sina)
    return _launch("onehot_apply_packed", tuple(As), slab, ranges, nty, ntx,
                   precision, rotate, cosa, sina, with_checksum)


# ------------------------------------------------------ plain versions ----

def _onehot_plain(As, slab, ranges, nty, ntx, precision, rotate, cosa, sina,
                  with_checksum):
    Cp = slab.shape[2]

    def row_block(i):
        t0, t1 = i * ntx, (i + 1) * ntx
        s = slab[t0:t1]
        blk = torch.zeros((ntx, TILE, Cp), dtype=torch.float32,
                          device=slab.device)
        for A, (c0, c1) in zip(As, ranges):
            blk[:, :, c0:c1] = _tile_matmul(_prep_A(A[t0:t1], precision),
                                            s[:, :, c0:c1], precision)
        return blk

    return _plain_rows(row_block, nty=nty, ntx=ntx, Cp=Cp, dev=slab.device,
                       rotate=rotate, cosa=cosa, sina=sina,
                       with_checksum=with_checksum)


def onehot_apply_plain(A, slab, *, nty, ntx, precision="split_bf16"):
    """``onehot_apply`` in plain PyTorch, on any device: per tile row the
    stacked-operand product (``_tile_matmul``), unblocked into row-major
    order (pallas_matmul.fused_apply's function)."""
    PLAIN_CALLS["onehot_apply"] += 1
    _check_onehot((A,), slab, precision)
    n_tiles, _, Cp = slab.shape
    _check_layout(n_tiles, Cp, ((0, Cp),), nty, ntx, (), None, None)
    return _onehot_plain((A,), slab, ((0, Cp),), nty, ntx, precision, (),
                         None, None, False)


def onehot_apply_packed_plain(As, slab, *, ranges, nty, ntx,
                              precision="split_bf16", with_checksum=False,
                              rotate=(), cosa=None, sina=None):
    """``onehot_apply_packed`` in plain PyTorch, on any device: per tile
    row and method the stacked-operand product, then the Q4 rotation,
    tail zeros, checksum and unblock of ops/packed_kernel.py."""
    PLAIN_CALLS["onehot_apply_packed"] += 1
    ranges, rotate = tuple(map(tuple, ranges)), tuple(map(tuple, rotate))
    _check_onehot(As, slab, precision)
    n_tiles, _, Cp = slab.shape
    _check_layout(n_tiles, Cp, ranges, nty, ntx, rotate, cosa, sina)
    if len(As) != len(ranges):
        raise ValueError("one A per range is required")
    return _onehot_plain(As, slab, ranges, nty, ntx, precision, rotate, cosa,
                         sina, with_checksum)
