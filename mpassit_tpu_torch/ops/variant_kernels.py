"""ELL-built one-hot apply in the split_bf16 term set: the two Hopper
kernels of the kernel-structure experiment, their plain twins and their
launch plan.

Counterparts of the TPU kernels ``make_v1`` and ``make_v2`` of
``tools/kernel_variants.py``. Both take the ELL arrays of one operator,
``loc`` (n_tiles, K, 1024) int32 and ``w`` (n_tiles, K, 1024) f32, with a
slab (n_tiles, W, Cp) f32, build each tile's one-hot operator

    A[r, p] = sum of w[t, k, p] over the k (in order) with loc[t, k, p] == r

for the rows 0 <= r < W, split A and the slab into bf16 parts (hi, lo) and
write the row-major ``(nty*32, ntx*32, Cp)`` output

    v1:  Ah^T Sh + Ah^T Sl + Al^T Sh          three products
    v2:  [Ah; Ah; Al]^T [Sh; Sl; Sh]          one stacked product

which are the same terms summed in another order. The kernels
(``csrc/ell_split_apply.cu``) build A from loc/w in shared memory and sum
the terms on the tensor cores (bf16 ``wgmma``, f32 accumulation, the
leading term in an accumulator of its own): v1 builds each 32-row window
of A in every block, v2 builds it once per strip of points and reuses it
for every column chunk. Both issue the same products in the same order,
so they agree bit for bit. A is summed in f32 before it is split, so
duplicate ``loc`` entries give the TPU's Ah/Al; entries outside [0, W)
add nothing. The plain versions build A with ``matmul_apply._build_A_T``
(JAX's sum order) and multiply the bf16 parts in f32
(``torch.backends.cuda.matmul.allow_tf32`` False, the default, on a card).

``ell_split_plan`` is the kernels' launch geometry as a pure function:
padded K, pipeline steps, columns per block (64 points each), the grid and
the dynamic shared memory, as the launch recomputes and checks it.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors; there is no fallback from one to the other. Nothing is
built at import.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass

import torch

from . import _build
from .matmul_apply import _build_A_T
from .onehot_kernel import _onehot_plain, _split_hilo
from .packed_kernel import LANE, TILE, TX, TY, _plain_rows, _route, _stream

#: ELL entries per point the kernels stage (MAXK in the .cu)
MAX_K = 16
#: v2's column chunks
V2_CC = (128, 256)
# the geometry of csrc/ell_split_apply.cu
PTS = 64            # target points per block: the wgmma M
KS = 32             # operator rows per pipeline step
STAGES = 3          # f32 slab steps in flight (the cp.async ring)
K_STEP = 16         # the wgmma depth: K is W padded to a multiple of it
LBO, SBO = 128, 256  # operand descriptors: core matrices along K, along M/N
EXTRA = 8           # row padding (floats) of the staged f32 tile
SMEM_MAX = 232_448  # dynamic shared memory a block can have on an H100
#: (variant, CC) -> columns per block: one warpgroup per 128
BLOCK = {("v1", 128): 128, ("v2", 128): 128, ("v2", 256): 256}


def _smem(variant, cols, K, Kpad):
    """csrc/ell_split_apply.cu::v1_smem / v2_smem: both keep STAGES f32
    slab steps in flight; v1 keeps a ring of two 32-row steps of A and
    slab parts (or the staged f32 tile, if larger) and the staged loc/w;
    v2 keeps both A parts for all Kpad rows and a ring of two slab steps,
    the staged tile or the staged loc/w, whichever is largest."""
    a_chunk, s_chunk = PTS * 32, cols * 32      # one k16 chunk of one part
    tile = PTS * (cols + EXTRA) * 4
    stages = STAGES * KS * cols * 4
    if variant == "v1":
        return (max(2 * (4 * a_chunk + 4 * s_chunk), tile) + stages
                + K * PTS * 8)
    return (2 * (Kpad // K_STEP) * a_chunk + stages
            + max(8 * s_chunk, tile, K * PTS * 8))


def _v2_max_w():
    """The widest slab (a multiple of K_STEP) whose v2 launch fits
    SMEM_MAX at K = MAX_K, for every CC."""
    return min(max(Kp for Kp in range(K_STEP, 4096, K_STEP)
                   if _smem("v2", BLOCK[("v2", cc)], MAX_K, Kp) <= SMEM_MAX)
               for cc in V2_CC)


#: v2 keeps [Ah; Al] of its points for all K rows in shared memory beside
#: the slab stages and ring: the widest slab it takes
V2_MAX_W = _v2_max_w()


@dataclass(frozen=True)
class EllSplitPlan:
    """The geometry of one launch of csrc/ell_split_apply.cu
    (``ell_split_plan``)."""

    variant: str
    CC: int
    n_tiles: int
    Cp: int
    K: int              # ELL entries per point
    Kpad: int           # W padded to a multiple of K_STEP
    steps: int          # KS-row pipeline steps per column chunk
    cols: int           # columns per block (per chunk for v2): 128 a
                        # warpgroup
    grid: int           # blocks: v1 (tile, chunk, strip), v2 (tile, strip)
    smem: int           # dynamic shared-memory bytes

    @property
    def flop(self):
        """Tensor-core FLOP of the launch: three terms at the padded K."""
        return 3 * 2 * self.n_tiles * TILE * self.Kpad * self.Cp


def ell_split_plan(n_tiles, W, Cp, K, variant, CC=128):
    """The launch geometry of ``ell_split_apply_v1`` (variant "v1", CC
    128) or ``ell_split_apply_v2`` (variant "v2", CC 128 or 256) for
    ``n_tiles`` tiles of a (W-row, Cp-column) slab and K ELL entries per
    point. Raises ValueError on what the kernels do not take: K outside
    [1, MAX_K], W < 1, Cp not a positive multiple of CC, v2 above
    V2_MAX_W, a grid over 2^31 - 1 blocks."""
    if (variant, CC) not in BLOCK:
        raise ValueError(f"no {variant} kernel at CC={CC}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K = {K} outside [1, {MAX_K}]")
    if W < 1 or n_tiles < 1:
        raise ValueError(f"W={W}, n_tiles={n_tiles}: need both >= 1")
    if Cp < CC or Cp % CC:
        raise ValueError(f"column count {Cp} not a positive multiple of "
                         f"{CC}")
    if variant == "v2" and W > V2_MAX_W:
        raise ValueError(f"slab width {W} > {V2_MAX_W}: v2's [Ah; Al] "
                         f"slice does not fit a block's shared memory")
    cols = BLOCK[(variant, CC)]
    Kpad = -(-W // K_STEP) * K_STEP
    grid = n_tiles * (TILE // PTS) * (Cp // cols if variant == "v1" else 1)
    if grid > 2 ** 31 - 1:
        raise ValueError(f"{grid} blocks exceed the grid limit")
    return EllSplitPlan(variant=variant, CC=CC, n_tiles=n_tiles, Cp=Cp, K=K,
                        Kpad=Kpad, steps=-(-Kpad // KS), cols=cols,
                        grid=grid, smem=_smem(variant, cols, K, Kpad))


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
_V1_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
_V2_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


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
    n_tiles, W, Cp = slab.shape
    K = loc.shape[1]
    plan = ell_split_plan(n_tiles, W, Cp, K, "v1" if CC is None else "v2",
                          CC or 128)
    lib = build()
    # the kernels read all three with 16-byte loads
    loc, w, slab = (t if t.is_contiguous() and t.data_ptr() % 16 == 0
                    else t.clone(memory_format=torch.contiguous_format)
                    for t in (loc, w, slab))
    out = torch.empty((nty * TY, ntx * TX, Cp),
                      dtype=torch.float32, device=slab.device)
    args = (loc.data_ptr(), w.data_ptr(), slab.data_ptr(), out.data_ptr(),
            n_tiles, ntx, K, W, Cp)
    with torch.cuda.device(slab.device):
        if CC is None:
            rc = lib.ell_split_v1_launch(*args, plan.smem,
                                         _stream(slab.device))
        else:
            rc = lib.ell_split_v2_launch(*args, CC, plan.smem,
                                         _stream(slab.device))
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
    builds A once per strip of target points and reuses it for every
    CC-column chunk (CC 128 or 256, Cp % CC == 0; slab width W <=
    V2_MAX_W): the function of tools/kernel_variants.make_v2."""
    _check(loc, w, slab, nty, ntx)
    if CC not in V2_CC or slab.shape[2] % CC:
        raise ValueError(f"CC must be one of {V2_CC} and divide Cp, got {CC}")
    if not _route("ell_split_apply_v2", slab.device, [loc, w]):
        return ell_split_apply_v2_plain(loc, w, slab, nty=nty, ntx=ntx)
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
