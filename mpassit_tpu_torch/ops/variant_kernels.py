"""ELL-built one-hot apply in the split_bf16 term set: the two Hopper
kernels of the kernel-structure experiment and their plain twins.

Counterparts of the TPU kernels ``make_v1`` and ``make_v2`` of
``tools/kernel_variants.py``. Both take the ELL arrays of one operator,
``loc`` (n_tiles, K, 1024) int32 and ``w`` (n_tiles, K, 1024) f32, with a
slab (n_tiles, W, Cp) f32, build each tile's one-hot operator

    A[r, p] = sum of w[t, k, p] over the k (in order) with loc[t, k, p] == r

for the rows r < W, split A and the slab into bf16 parts (hi, lo) and
write the row-major ``(nty*32, ntx*32, Cp)`` output

    v1:  Ah^T Sh + Ah^T Sl + Al^T Sh          three products
    v2:  [Ah; Ah; Al]^T [Sh; Sl; Sh]          one stacked product

which are the same terms summed in another order (``csrc/ell_split_apply.cu``
has the kernels' designs). A is summed in f32 before it is split, so
duplicate ``loc`` entries give the TPU's Ah/Al; rows >= W and w = 0 pads
add nothing. The plain versions build A with ``matmul_apply._build_A_T``
(JAX's sum order) and multiply the bf16 parts in f32
(``torch.backends.cuda.matmul.allow_tf32`` False, the default, on a card).

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; there is no fallback from one to the other. Nothing is
built at import.
"""

from __future__ import annotations

import os
import threading

import torch

from . import _build
from .matmul_apply import _build_A_T
from .onehot_kernel import _onehot_plain, _split_hilo
from .packed_kernel import LANE, TILE, TX, TY, _plain_rows, _route, _stream

#: ELL entries per point the kernels stage (MAXK in the .cu)
MAX_K = 16
#: v2 keeps a (W, 32)-point slice of [Ah; Al] in 16-byte entries in shared
#: memory beside 4 KB of staged loc/w: W * 512 + 4096 <= 232,448 bytes
V2_MAX_W = 446
#: v2's column chunks (threads per block)
V2_CC = (128, 256)

#: kernel launches per wrapper (one per call on a CUDA tensor)
LAUNCHES = {"ell_split_apply_v1": 0, "ell_split_apply_v2": 0}
#: calls of each plain version
PLAIN_CALLS = {"ell_split_apply_v1": 0, "ell_split_apply_v2": 0}

SOURCE = os.path.join(_build.CSRC, "ell_split_apply.cu")
BUILD_DIR = _build.BUILD_DIR

_lock = threading.Lock()
_lib = None
#: what the last build did: {"so", "seconds", "log"}
BUILD_INFO: dict = {}

_P, _I = _build.P, _build.I
_V1_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
_V2_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]


def build():
    """Compile ``csrc/ell_split_apply.cu`` (once per source content) and
    load it. Returns the ctypes library; raises on a failed build or
    load."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build.load(SOURCE, BUILD_DIR,
                               {"ell_split_v1_launch": _V1_ARGTYPES,
                                "ell_split_v2_launch": _V2_ARGTYPES},
                               BUILD_INFO)
        return _lib


def _check(loc, w, slab, nty, ntx):
    if slab.dim() != 3 or slab.dtype != torch.float32:
        raise ValueError("slab must be a (n_tiles, W, Cp) float32 tensor")
    n_tiles, _, Cp = slab.shape
    if n_tiles != nty * ntx:
        raise ValueError(f"slab has {n_tiles} tiles, grid wants {nty * ntx}")
    if Cp % LANE:
        raise ValueError(f"column count {Cp} not a multiple of {LANE}")
    if (loc.dim() != 3 or loc.shape[0] != n_tiles or loc.shape[2] != TILE
            or loc.dtype != torch.int32):
        raise ValueError("loc must be (n_tiles, K, 1024) int32")
    if w.shape != loc.shape or w.dtype != torch.float32:
        raise ValueError("w must match loc in shape, float32")
    if not 1 <= loc.shape[1] <= MAX_K:
        raise ValueError(f"K = {loc.shape[1]} outside [1, {MAX_K}]")


def _launch(name, loc, w, slab, nty, ntx, CC=None):
    lib = build()
    loc, w, slab = loc.contiguous(), w.contiguous(), slab.contiguous()
    n_tiles, W, Cp = slab.shape
    K = loc.shape[1]
    out = torch.empty((nty * TY, ntx * TX, Cp),
                      dtype=torch.float32, device=slab.device)
    args = (loc.data_ptr(), w.data_ptr(), slab.data_ptr(), out.data_ptr(),
            n_tiles, ntx, K, W, Cp)
    with torch.cuda.device(slab.device):
        if CC is None:
            rc = lib.ell_split_v1_launch(*args, _stream(slab.device))
        else:
            rc = lib.ell_split_v2_launch(*args, CC, _stream(slab.device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: rc={rc}")
    LAUNCHES[name] += 1
    return out


def ell_split_apply_v1(loc, w, slab, *, nty, ntx):
    """The operator of ``loc``/``w`` applied to ``slab`` (Cp % 128 == 0)
    as Ah^T Sh + Ah^T Sl + Al^T Sh; (nty*32, ntx*32, Cp) f32 (the function
    of tools/kernel_variants.make_v1)."""
    _check(loc, w, slab, nty, ntx)
    if not _route("ell_split_apply_v1", slab.device, [loc, w]):
        return ell_split_apply_v1_plain(loc, w, slab, nty=nty, ntx=ntx)
    return _launch("ell_split_apply_v1", loc, w, slab, nty, ntx)


def ell_split_apply_v2(loc, w, slab, *, nty, ntx, CC=128):
    """As ``ell_split_apply_v1``, summed as the stacked product; the kernel
    builds A once per 32 target points and reuses it for every CC-column
    chunk (CC 128 or 256, Cp % CC == 0; slab width W <= 446): the function
    of tools/kernel_variants.make_v2."""
    _check(loc, w, slab, nty, ntx)
    if CC not in V2_CC or slab.shape[2] % CC:
        raise ValueError(f"CC must be one of {V2_CC} and divide Cp, got {CC}")
    if not _route("ell_split_apply_v2", slab.device, [loc, w]):
        return ell_split_apply_v2_plain(loc, w, slab, nty=nty, ntx=ntx)
    if slab.shape[1] > V2_MAX_W:
        raise ValueError(f"slab width {slab.shape[1]} > {V2_MAX_W}: v2's "
                         f"[Ah; Al] slice does not fit a block's shared "
                         f"memory")
    return _launch("ell_split_apply_v2", loc, w, slab, nty, ntx, CC)


# ------------------------------------------------------ plain versions ----

def _one_hot(loc, w, W):
    """(n_tiles, K, 1024) loc/w -> the (n_tiles, W, 1024) f32 operator,
    summed in k order (``_build_A_T``); entries outside [0, W) add
    nothing."""
    n_tiles, K, _ = loc.shape
    loc = loc.long()
    out = (loc < 0) | (loc >= W)
    loc = loc.masked_fill(out, 0).transpose(1, 2).reshape(-1, K)
    w = w.masked_fill(out, 0.0).transpose(1, 2).reshape(-1, K)
    return _build_A_T(loc, w, n_tiles, W)


def ell_split_apply_v1_plain(loc, w, slab, *, nty, ntx):
    """``ell_split_apply_v1`` in plain PyTorch, on any device: per tile
    row the three products of the bf16 parts in f32, added in the TPU
    kernel's order ((Ah Sh + Ah Sl) + Al Sh)."""
    PLAIN_CALLS["ell_split_apply_v1"] += 1
    _check(loc, w, slab, nty, ntx)
    A = _one_hot(loc, w, slab.shape[1])

    def row_block(i):
        t0, t1 = i * ntx, (i + 1) * ntx
        ah, al = (a.float().transpose(1, 2) for a in _split_hilo(A[t0:t1]))
        sh, sl = (s.float() for s in _split_hilo(slab[t0:t1]))
        return torch.bmm(ah, sh) + torch.bmm(ah, sl) + torch.bmm(al, sh)

    return _plain_rows(row_block, nty=nty, ntx=ntx, Cp=slab.shape[2],
                       dev=slab.device)


def ell_split_apply_v2_plain(loc, w, slab, *, nty, ntx):
    """``ell_split_apply_v2`` in plain PyTorch, on any device: per tile
    row the stacked product of ops/onehot_kernel.py at split_bf16."""
    PLAIN_CALLS["ell_split_apply_v2"] += 1
    _check(loc, w, slab, nty, ntx)
    A = _one_hot(loc, w, slab.shape[1])
    return _onehot_plain((A,), slab, ((0, slab.shape[2]),), nty, ntx,
                         "split_bf16", (), None, None, False)
