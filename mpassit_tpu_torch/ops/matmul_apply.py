"""Tile-packed ELL apply (counterpart of mpassit_tpu/ops/matmul_apply.py).

The target grid is cut into 32x32 tiles. Per tile, the host pack
(``_pack_union``, copied verbatim from the JAX package) lists the sorted
union of source rows the tile's ELL entries reference (``slab_idx``, W
rows) and re-expresses each entry as a local row index into that list
(``loc``). An apply is then::

    slab = src[slab_idx]                       (one row gather on device)
    out  = packed_apply(slab, loc, w, ...)     (the Hopper kernel)

``packed_apply`` (ops/packed_kernel.py) writes the row-major
``(nty*32, ntx*32, Cp)`` output directly. On a CUDA device it launches the
kernel; on the CPU it runs the kernel's plain PyTorch version. The JAX
package's one-hot matmul formulation, its bf16 operand splits and its
VMEM/Mosaic routing knobs are TPU devices with no counterpart here: the
``precision`` argument is validated and kept for the namelist's sake, and
every value runs the same f32 arithmetic.

Both engines take host sources as one (n_src, C) array or as a list of
column blocks, assembled on the device without a host concatenation.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..parallel.multihost import fetch_to_host
from .packed_kernel import _validate_rotate, packed_apply

TY = 32
TX = 32
TILE = TY * TX
#: column padding quantum (the kernel's 128-column block width)
LANE = 128
#: columns per host-fetch strip
CB = 256
#: columns per kernel launch in SlabMatmulRegridder.apply_np: bounds device
#: residency to one (nyp, nxp, FETCH) output group
FETCH = 512
W_STEP = 8          # slab width quantum
#: max unique source rows per tile (a 32x32 EDGE-stagger tile reads a
#: (33, 33) window = 1089 rows of the mass grid)
W_CAP = 2048

#: accepted apply_precision values (all run f32 multiply-adds here)
PRECISIONS = ("split_bf16", "split6_bf16", "highest")


def _tile_block(arr_g, nty, ntx, K):
    return arr_g.reshape(nty, TY, ntx, TX, K).transpose(
        0, 2, 1, 3, 4).reshape(-1, K)


def _pack_union(idx, w, ny, nx, n_src):
    """Tile-block an ELL operator (or the K-concatenation of several over
    the same source row space) and compute, per 32x32 target tile, the
    packed union of unique source rows plus each entry's local slab index.
    The JAX package's ``_pack_union`` without its multi-device padding.

    Returns (slab_idx (n_tiles, W), loc (n_tiles, TILE*K), loc_w, W, nty,
    ntx, n_tiles)."""
    K = idx.shape[1]
    nty = -(-ny // TY)
    ntx = -(-nx // TX)
    nyp, nxp = nty * TY, ntx * TX
    idx_g = np.zeros((nyp, nxp, K), np.int64)
    w_g = np.zeros((nyp, nxp, K), np.float64)
    idx_g[:ny, :nx] = idx.reshape(ny, nx, K)
    w_g[:ny, :nx] = w.reshape(ny, nx, K)
    idx_b = _tile_block(idx_g, nty, ntx, K)
    w_b = _tile_block(w_g, nty, ntx, K)

    n_tiles = nty * ntx
    S1 = n_src + 1                            # per-tile sentinel spacing
    tid = idx_b.reshape(n_tiles, TILE * K)
    valid = (w_b != 0).reshape(n_tiles, TILE * K)

    # --- vectorized per-tile unique + searchsorted ---------------------
    # offset each tile's ids into a disjoint range, sentinel = tile max
    offs = (np.arange(n_tiles, dtype=np.int64) * S1)[:, None]
    coded = np.where(valid, tid, n_src) + offs           # (n_tiles, T*K)
    s = np.sort(coded, axis=1)
    first = np.ones_like(s, dtype=bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    is_real = (s - offs) < n_src
    uniq_mask = first & is_real
    counts = uniq_mask.sum(axis=1)
    max_u = max(int(counts.max()), 1)
    if max_u > W_CAP:
        raise ValueError(
            f"tile references {max_u} unique source rows > {W_CAP}")
    W = -(-max_u // W_STEP) * W_STEP

    # packed sorted unique ids per tile (sentinel-padded)
    slab_coded = np.full((n_tiles, W), -1, dtype=np.int64)
    pos = np.cumsum(uniq_mask, axis=1) - 1
    trows = np.broadcast_to(np.arange(n_tiles)[:, None], s.shape)
    slab_coded[trows[uniq_mask], pos[uniq_mask]] = s[uniq_mask]
    pad = slab_coded < 0
    slab_coded[pad] = (offs + n_src).repeat(W, axis=1)[pad]

    # global searchsorted over the disjointly-offset key space: each
    # tile's sorted uniques are < its sentinel pads (offs + n_src),
    # which are < the next tile's smallest key (offs + n_src + 1), so
    # the flattened key array is globally nondecreasing
    flat_keys = slab_coded.reshape(-1)
    loc_flat = np.searchsorted(flat_keys, coded.reshape(-1))
    loc = (loc_flat - np.repeat(np.arange(n_tiles), TILE * K) * W).astype(
        np.int32).reshape(n_tiles, TILE * K)
    loc = np.clip(np.where(valid, loc, 0), 0, W - 1)

    slab_idx = np.where(pad, 0, slab_coded - offs).astype(np.int64)
    loc_w = np.where(valid, w_b.reshape(n_tiles, TILE * K), 0.0)
    return slab_idx, loc, loc_w, W, nty, ntx, n_tiles


#: pack-cache layout version — bump when the cached entry changes
_PACK_VERSION = 4


def _pack_cache_path(cache_dir, ell_fps, ny, nx):
    """Entry path under the weights cache. The prefix differs from the JAX
    package's ``pack_`` entries, whose layout holds more arrays."""
    h = hashlib.sha256()
    h.update(f"v{_PACK_VERSION}|{TY}x{TX}|{W_STEP}|{W_CAP}|"
             f"{ny}x{nx}".encode())
    for fp in ell_fps:
        h.update(b"|" + fp.encode())
    return os.path.join(cache_dir, f"torchpack_{h.hexdigest()[:20]}")


def _pack_compact(out):
    """Shrink _pack_union's output to the dtypes the consumers need: loc
    values are < W (uint8/int16 instead of int32), loc_w feeds an f32
    apply."""
    slab_idx, loc, loc_w, W, nty, ntx, n_tiles = out
    ldt = np.uint8 if W <= 256 else (np.int16 if W <= 32767 else np.int32)
    return (slab_idx, loc.astype(ldt), loc_w.astype(np.float32), W, nty,
            ntx, n_tiles)


def _pack_union_cached(idx_w_fn, ny, nx, n_src, cache_dir=None,
                       ell_fps=None):
    """Disk-cached ``_pack_compact(_pack_union(...))``, keyed by the ELLs'
    content fingerprints so any weight change invalidates. ``idx_w_fn`` is
    a thunk returning the (idx, w) K-concatenation, evaluated on a miss."""
    from mpassit_tpu.diskcache import load_arrays, save_arrays

    path = None
    if cache_dir and ell_fps:
        os.makedirs(cache_dir, exist_ok=True)
        path = _pack_cache_path(cache_dir, ell_fps, ny, nx)
        hit = load_arrays(path)
        if hit is not None:
            try:
                meta, arrs = hit
                return (arrs["slab_idx"], arrs["loc"], arrs["loc_w"],
                        int(meta["W"]), int(meta["nty"]), int(meta["ntx"]),
                        int(meta["n_tiles"]))
            except KeyError:
                pass  # incomplete entry: rebuild
    idx, w = idx_w_fn()
    out = _pack_compact(_pack_union(idx, w, ny, nx, n_src))
    if path is not None:
        slab_idx, loc, loc_w, W, nty, ntx, n_tiles = out
        save_arrays(path, {"W": W, "nty": nty, "ntx": ntx,
                           "n_tiles": n_tiles},
                    {"slab_idx": slab_idx, "loc": loc, "loc_w": loc_w})
    return out


def _src_to_device(src, Cp, device):
    """Host source -> (n_src, Cp) f32 device tensor, zero-padded columns.

    Accepts one (n_src, C) array OR a list of column blocks summing to C:
    blocks are copied one at a time into a preallocated device buffer, so
    the host never materializes the concatenated matrix and the extra
    host memory is one block."""
    if not isinstance(src, (list, tuple)):
        src = np.asarray(src, dtype=np.float32)
        if src.ndim == 1:
            src = src[:, None]
        src = [src]
    buf = torch.zeros((np.asarray(src[0]).shape[0], Cp), dtype=torch.float32,
                      device=device)
    off = 0
    for b in src:
        b = np.ascontiguousarray(np.asarray(b, dtype=np.float32))
        if b.ndim == 1:
            b = b[:, None]
        buf[:, off:off + b.shape[1]] = torch.from_numpy(b).to(device)
        off += b.shape[1]
    return buf


def _fetch_strips(o, C, ny, nx, lo0, root_only, out, strip_sink):
    """Fetch columns [lo0, lo0 + o's width) ∩ [0, C) of a device result to
    the host in CB-column strips: into ``out`` or to ``strip_sink``."""
    for lo in range(lo0, min(lo0 + o.shape[2], C), CB):
        cb_eff = min(CB, C - lo, lo0 + o.shape[2] - lo)
        fetched = fetch_to_host(o[:ny, :nx, lo - lo0:lo - lo0 + cb_eff],
                                root_only=root_only)
        if strip_sink is not None:
            strip_sink(lo, fetched)
        else:
            out[:, :, lo:lo + cb_eff] = fetched


class SlabMatmulRegridder:
    """One tile-packed ELL operator, applied by the packed kernel with one
    column range.

    Raises ValueError when a tile references more than W_CAP unique source
    rows (the caller falls back to ops.apply.Regridder)."""

    #: apply_np accepts a list of column blocks (device-side assembly)
    accepts_blocks = True

    def __init__(self, ell, device, precision: str = "highest",
                 cache_dir=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.precision = precision
        self.device = torch.device(device)
        self.cache_dir = cache_dir
        if len(ell.dst_shape) != 2:
            raise ValueError("SlabMatmulRegridder needs a 2-D dst_shape")
        ny, nx = ell.dst_shape
        self._K = ell.idx.shape[1]
        self.n_src = ell.n_src
        self.dst_shape = (ny, nx)
        (slab_idx, self._loc_host, self._w_host, self.W, self.nty, self.ntx,
         self.n_tiles) = _pack_union_cached(
            lambda: (np.asarray(ell.idx, dtype=np.int64),
                     np.asarray(ell.w, dtype=np.float64)),
            ny, nx, self.n_src, cache_dir=cache_dir,
            ell_fps=(ell.fingerprint(),) if cache_dir else None)
        self.slab_idx = torch.tensor(np.asarray(slab_idx).reshape(-1),
                                     device=self.device)
        self._locw_dev = None
        self.duplication = self.n_tiles * self.W / max(ell.n_src, 1)

    def _ell_dev(self):
        """loc/w in the kernel's (n_tiles, K, TILE) layout, on device."""
        if self._locw_dev is None:
            lw = []
            for a, dt in ((self._loc_host, np.int32),
                          (self._w_host, np.float32)):
                a3 = np.ascontiguousarray(
                    np.asarray(a).reshape(self.n_tiles, TILE, self._K)
                    .transpose(0, 2, 1)).astype(dt)
                lw.append(torch.from_numpy(a3).to(self.device))
            self._locw_dev = tuple(lw)
        return self._locw_dev

    def _slab(self, src_dev):
        """(n_src, Cp) -> (n_tiles, W, Cp): the one row gather."""
        return torch.index_select(src_dev, 0, self.slab_idx).view(
            self.n_tiles, self.W, src_dev.shape[1])

    def _apply(self, slab):
        loc, w = self._ell_dev()
        return packed_apply(slab, (loc,), (w,), ranges=((0, slab.shape[2]),),
                            nty=self.nty, ntx=self.ntx)

    def __call__(self, src_dev):
        """src (n_src, C) tensor on the operator's device. Returns the
        (nyp, nxp, C) device result (tile-padded grid)."""
        if src_dev.dim() == 1:
            src_dev = src_dev[:, None]
        C = src_dev.shape[1]
        pad = (-C) % LANE
        if pad:
            src_dev = torch.nn.functional.pad(src_dev, (0, pad))
        return self._apply(self._slab(src_dev.float()))[:, :, :C]

    def apply_np(self, src, root_only: bool = False, strip_sink=None):
        """Host-array apply: one slab gather, then one kernel launch per
        FETCH-column group, fetched to the host in CB strips before the
        next group allocates (device residency is one group's output).

        ``src`` may be a list of column blocks. With ``strip_sink``, each
        fetched (ny, nx, cb) strip is handed to ``strip_sink(col_lo,
        strip)`` instead of being assembled, and None is returned."""
        def ncols(b):
            return 1 if np.ndim(b) == 1 else np.shape(b)[1]

        is_blocks = isinstance(src, (list, tuple))
        squeeze = not is_blocks and np.ndim(src) == 1
        C = sum(ncols(b) for b in src) if is_blocks else ncols(src)
        Cp = C + ((-C) % LANE)
        slab = self._slab(_src_to_device(src, Cp, self.device))
        ny, nx = self.dst_shape
        out = None if strip_sink is not None else np.empty((ny, nx, C),
                                                           np.float32)
        for g in range(0, Cp, FETCH):
            gw = min(FETCH, Cp - g)
            o = self._apply(slab[:, :, g:g + gw].contiguous())
            _fetch_strips(o, C, ny, nx, g, root_only, out, strip_sink)
            del o
        if strip_sink is not None:
            return None
        return out[:, :, 0] if squeeze else out


class PackedSlabRegridder:
    """Several ELL operators over the SAME source row space and target
    grid, applied as ONE kernel pass writing ONE packed output.

    ``ells_and_cols``: list of (ELLWeights, n_cols) in column order; the
    apply consumes one (n_src, sum(n_cols)) source laid out the same way.
    The per-tile slab is the union of the methods' unique source rows; the
    kernel writes each method's sum into its column range.

    ``rotate_spec``: optional (windows, cosa, sina) — windows is a tuple of
    (cu, cv, n) packed-column triples (u levels at [cu, cu+n), v at
    [cv, cv+n)); cosa/sina are (ny, nx) host arrays. The Q4 wind rotation
    is applied to those columns inside the kernel. A window that does not
    fit one 256-column sub-chunk raises ValueError, as in the JAX package,
    so that both packages take the same rotation route.
    """

    #: apply_np accepts a list of column blocks (device-side assembly)
    accepts_blocks = True

    def __init__(self, ells_and_cols, device, precision: str = "highest",
                 rotate_spec=None, cache_dir=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        self.precision = precision
        self.device = torch.device(device)
        self.cache_dir = cache_dir
        ells = [e for e, _ in ells_and_cols]
        self.col_counts = [int(c) for _, c in ells_and_cols]
        if len({e.n_src for e in ells}) != 1:
            raise ValueError("packed operators must share one source space")
        if len({tuple(e.dst_shape) for e in ells}) != 1:
            raise ValueError("packed operators must share the target grid")
        ny, nx = ells[0].dst_shape
        self.n_src = ells[0].n_src
        self.dst_shape = (ny, nx)
        self.C_total = sum(self.col_counts)
        # column ranges per method within the packed output
        self.ranges = []
        off = 0
        for c in self.col_counts:
            self.ranges.append((off, off + c))
            off += c
        # validate rotate windows BEFORE the expensive union pack: callers
        # fall back to a rotation-free regridder on ValueError
        if rotate_spec is not None:
            _validate_rotate(tuple(rotate_spec[0]), tuple(self.ranges),
                             self.Cp)

        # union slab over the K-concatenation of all methods
        self._Ks = [e.idx.shape[1] for e in ells]

        def _cat():
            return (np.concatenate(
                        [np.asarray(e.idx, np.int64) for e in ells], axis=1),
                    np.concatenate(
                        [np.asarray(e.w, np.float64) for e in ells], axis=1))

        (slab_idx, loc, loc_w, self.W, self.nty, self.ntx,
         self.n_tiles) = _pack_union_cached(
            _cat, ny, nx, self.n_src, cache_dir=cache_dir,
            ell_fps=(tuple(e.fingerprint() for e in ells)
                     if cache_dir else None))
        self.slab_idx = torch.tensor(np.asarray(slab_idx).reshape(-1),
                                     device=self.device)
        # per-method loc/w slices over the union slab (following the
        # K-concatenation order); the kernel-layout device arrays are
        # derived lazily from these
        self._loc3 = loc.reshape(self.n_tiles, TILE, sum(self._Ks))
        self._w3 = loc_w.reshape(self.n_tiles, TILE, sum(self._Ks))
        self._locws = None

        # in-kernel wind rotation (quirk Q4): cosa/sina tile-blocked
        # (n_tiles, TY, TX) and padded with the IDENTITY rotation (cosa=1,
        # sina=0) outside the data region — zero padding would put 0/0
        # NaNs in the padded rows
        self.rotate = ()
        self._cosa_t = self._sina_t = None
        if rotate_spec is not None:
            windows, cosa, sina = rotate_spec
            cs = np.zeros((self.nty * TY, self.ntx * TX, 2), np.float32)
            cs[:, :, 0] = 1.0
            cs[:ny, :nx, 0] = np.asarray(cosa, np.float32).reshape(ny, nx)
            cs[:ny, :nx, 1] = np.asarray(sina, np.float32).reshape(ny, nx)
            cs_t = _tile_block(cs, self.nty, self.ntx, 2).reshape(
                self.n_tiles, TY, TX, 2)
            self.rotate = tuple(tuple(w) for w in windows)
            self._cosa_t = torch.from_numpy(
                np.ascontiguousarray(cs_t[..., 0])).to(self.device)
            self._sina_t = torch.from_numpy(
                np.ascontiguousarray(cs_t[..., 1])).to(self.device)

    @property
    def Cp(self) -> int:
        return self.C_total + ((-self.C_total) % LANE)

    def _ell_dev(self):
        """Per-method (n_tiles, K, TILE) loc/w device tensors."""
        if self._locws is None:
            locs, ws = [], []
            koff = 0
            for K in self._Ks:
                lm = np.ascontiguousarray(
                    np.asarray(self._loc3[:, :, koff:koff + K])
                    .transpose(0, 2, 1)).astype(np.int32)
                wm = np.ascontiguousarray(
                    np.asarray(self._w3[:, :, koff:koff + K])
                    .transpose(0, 2, 1)).astype(np.float32)
                locs.append(torch.from_numpy(lm).to(self.device))
                ws.append(torch.from_numpy(wm).to(self.device))
                koff += K
            self._locws = (tuple(locs), tuple(ws))
        return self._locws

    def _apply_padded(self, src_dev):
        """(n_src, Cp) device source -> (nyp, nxp, Cp); columns past
        C_total are zeroed by the kernel."""
        slab = torch.index_select(src_dev, 0, self.slab_idx).view(
            self.n_tiles, self.W, self.Cp)
        locs, ws = self._ell_dev()
        return packed_apply(slab, locs, ws, ranges=tuple(self.ranges),
                            nty=self.nty, ntx=self.ntx, rotate=self.rotate,
                            cosa=self._cosa_t, sina=self._sina_t)

    def __call__(self, src_dev):
        """src (n_src, C_total) tensor on the operator's device, columns
        laid out per ``ells_and_cols``. Returns (nyp, nxp, C_total)."""
        if src_dev.shape[1] != self.C_total:
            raise ValueError(
                f"packed source has {src_dev.shape[1]} columns, operator "
                f"expects {self.C_total}")
        pad = self.Cp - self.C_total
        src_dev = torch.nn.functional.pad(src_dev.float(), (0, pad))
        return self._apply_padded(src_dev)[:, :, :self.C_total]

    def apply_np(self, src, root_only: bool = False, strip_sink=None):
        """Host apply in one full-width kernel pass, fetched in CB strips
        (see SlabMatmulRegridder.apply_np). ``src`` may be a list of
        column blocks; with ``strip_sink`` each strip streams to the sink
        and None is returned."""
        ny, nx = self.dst_shape
        out = None if strip_sink is not None else np.empty(
            (ny, nx, self.C_total), np.float32)
        o = self._apply_padded(_src_to_device(src, self.Cp, self.device))
        _fetch_strips(o, self.C_total, ny, nx, 0, root_only, out, strip_sink)
        return out
