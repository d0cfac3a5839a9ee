"""Tile-packed ELL apply (counterpart of mpassit_tpu/ops/matmul_apply.py).

The target grid is cut into 32x32 tiles. Per tile, the host pack
(``_pack_union``, copied verbatim from the JAX package) lists the sorted
union of source rows the tile's ELL entries reference (``slab_idx``, W
rows) and re-expresses each entry as a local row index into that list
(``loc``). ``PackedSlabRegridder`` holds the pack of one operator, or of
the union of several over one source and one target, and applies it by
one of three routes, chosen when it is built from the JAX package's
switches:

- default: ``slab = src[slab_idx]`` (one row gather on the device), then
  ``packed_apply`` (ops/packed_kernel.py), fed the ELL arrays directly, f32;
- ``MPASSIT_ELL_KERNEL=0``, the one-hot route: the same gather, then
  ``onehot_apply_packed`` (ops/onehot_kernel.py) with the f32 one-hot
  operators that ``_build_A_T`` builds on the device, computing the TPU's
  term set of ``precision``;
- ``MPASSIT_GATHER_KERNEL=1``, the in-kernel-gather route:
  ``packed_gather_apply`` (ops/gather_kernel.py) reads the slab rows from
  the source through the chunked-run layout of ``_chunk_slab``; no slab is
  held in device memory. ``MPASSIT_ELL_KERNEL=0`` wins over it.

Every kernel writes the row-major ``(nty*32, ntx*32, Cp)`` output
directly. On a CUDA device the wrappers launch their kernels; on the CPU
they run the kernels' plain PyTorch versions. No route gives way to
another. The JAX package's VMEM checks (``ell_fits_vmem``,
``gather_fits_vmem``, ``fused_available``) and ``MPASSIT_APPLY_BACKEND``
have no counterpart: the switches alone pick the route. On the default
and gather routes every ``precision`` runs the same f32 arithmetic.

The regridder takes host sources as one (n_src, C) array or as a list of
column blocks, assembled on the device without a host concatenation.
When one full-width pass would not fit the device budget
(``device_budget``), it runs in column groups, each uploaded, applied by
one kernel launch, fetched and freed in turn (``_grouped_width``); the
result is the full-width one, bit for bit.

With a ``mesh`` (parallel/sharding.GridMesh; the pipeline's
``n_device_shards``), the regridder runs tile-row sharded, the counterpart
of the ``shard_map`` branches of the JAX package's ``_fused_full``: the
tile rows are padded to a multiple of the world size (zero tiles), each
rank keeps ``slab_idx``, ``loc``, ``loc_w``, its one-hot operators and
the rotation's cosa/sina for its own band of ``nty_l`` tile rows only, and
launches the route's kernel over that band. The source is replicated. The
fetch gathers each row chunk from every rank (``_fetch_strips``). The pack
cache keeps the unbanded pack, so one entry serves every world size. The
gather route is off under a mesh, as in the JAX package (its
``_use_gather`` needs ``mesh is None``): ``MPASSIT_GATHER_KERNEL=1`` with
a mesh runs the default route. The grouped apply runs sharded, the same
group loop on every rank (the group width agreed as the ranks' least).

Spans (``spans.py``): each pack loaded or built is a ``weights.pack``, a
route's device operands built on first use ``apply.operands``, each
column group's upload ``apply.upload`` and its fetch ``apply.fetch``; the
counters ``apply.upload_bytes``, ``apply.fetch_bytes`` (host bytes each
way), ``apply.fetch_staged_bytes`` (the fetched bytes that crossed
through page-locked staging buffers: all of them on a CUDA device, 0 on
the CPU), ``apply.groups`` (launches), ``apply.slab_bytes`` (what each
launch's tiles stage from the source: tiles x slab rows x the launch's
columns x 4; slab rows are W, or W8 on the gather route) and
``pack.cache_hits``/``_misses``.
"""

from __future__ import annotations

import hashlib
import itertools
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.multihost import gather_bands
from ..parallel.sharding import band_rows
from ..spans import count, span
from .gather_kernel import CH, packed_gather_apply
from .onehot_kernel import onehot_apply_packed
from .packed_kernel import _validate_rotate, packed_apply

TY = 32
TX = 32
TILE = TY * TX
#: column padding quantum (the kernel's 128-column block width)
LANE = 128
#: columns per host-fetch strip
CB = 256
#: the column-group width the grouped apply starts from
#: (``PackedSlabRegridder._grouped_width``): a source of at most FETCH
#: padded columns is never grouped
FETCH = 512
#: device-to-host bytes of one row chunk of a fetch (``_fetch_strips``),
#: as of each of the two page-locked staging buffers it crosses through:
#: resident host memory kept small, copies still at the pinned rate
FETCH_CHUNK = 1 << 24
#: share of a CUDA device's free bytes the grouped apply plans on; the rest
#: is left to the caching allocator's rounding and fragmentation
FREE_SHARE = 0.9
W_STEP = 8          # slab width quantum
#: max unique source rows per tile (a 32x32 EDGE-stagger tile reads a
#: (33, 33) window = 1089 rows of the mass grid)
W_CAP = 2048

#: accepted apply_precision values (the one-hot route computes each one's
#: term set; the default and gather routes run f32 multiply-adds)
PRECISIONS = ("split_bf16", "split6_bf16", "highest")


def _route_from_env() -> str:
    """"ell" (default), "onehot" (MPASSIT_ELL_KERNEL=0) or "gather"
    (MPASSIT_GATHER_KERNEL=1), read when a regridder is built, as the JAX
    package reads them (matmul_apply.py:563, :645)."""
    if os.environ.get("MPASSIT_ELL_KERNEL", "1") == "0":
        return "onehot"
    if os.environ.get("MPASSIT_GATHER_KERNEL", "0") == "1":
        return "gather"
    return "ell"


def _build_A_T(loc, w, n_tiles, w_width):
    """(T, K) local indices + f32 weights, device tensors -> the
    (n_tiles, W, TILE) f32 one-hot sums A[t, r, p] = sum of w[p, k] over
    the k with loc[p, k] == r (the JAX package's _build_A_T).

    The K entries are added in order k = 0..K-1, each by one
    non-accumulating index_put_ into a preallocated A: within one k no
    (tile, row, point) repeats, so the sum order is JAX's and the result
    deterministic. Memory beyond A is a few (T,) index vectors."""
    T, K = loc.shape
    dev = loc.device
    A = torch.zeros((n_tiles, w_width, TILE), dtype=torch.float32,
                    device=dev)
    flat = A.view(-1)
    pt = torch.arange(T, device=dev)
    base = (pt // TILE) * (w_width * TILE) + pt % TILE
    for k in range(K):
        idx = base + loc[:, k].long() * TILE
        flat.index_put_((idx,), flat[idx] + w[:, k].float())
    return A


def _per_method(a, n_tiles, Ks, dtype, device):
    """(n_tiles, TILE*sum(Ks)) host array, K-concatenated per point ->
    one (n_tiles, K, TILE) device tensor per method (the kernels'
    layout)."""
    a3 = np.asarray(a).reshape(n_tiles, TILE, sum(Ks))
    out, koff = [], 0
    for K in Ks:
        out.append(torch.from_numpy(np.ascontiguousarray(
            a3[:, :, koff:koff + K].transpose(0, 2, 1)).astype(dtype))
            .to(device))
        koff += K
    return tuple(out)


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


def _chunk_slab(slab_idx, loc, loc_w, W):
    """Chunked-run layout for the in-kernel gather: per tile, the sorted
    unique source rows cluster into contiguous runs under Morton ordering
    (measured: ~20 runs / ~25 8-row chunks per tile at the 2.6M-cell
    W=80 load; ~7 at CONUS W=16). Each run becomes ceil(L/CH) fixed-size
    (CH, Cp) DMA copies from src into a per-tile slab scratch whose slots
    are CH-padded per run — the whole slab gather is ~25 descriptor
    issues per tile instead of a separate XLA gather pass over HBM.

    Chunk starts are CH-ALIGNED source rows (stored divided by CH —
    Mosaic can only prove the (8, 128)-tiled HBM slice legal when the
    row offset is an explicit multiple of 8), so each run's copies cover
    [floor(r0/CH)*CH, r0+L) and its rows land at slot base + (r0 - a0)
    + i.

    Returns (ch_src (n_tiles, NC) int32 chunk starts DIVIDED BY CH (pad
    chunks point at row 0 and land in slots no weight references), loc8
    (n_tiles, TILE*K) remapped local indices, W8 = NC*CH)."""
    n_tiles, W_ = slab_idx.shape
    lw = np.asarray(loc_w).reshape(n_tiles, -1)
    lc = np.asarray(loc).reshape(n_tiles, -1).astype(np.int64)
    used = np.zeros((n_tiles, W_), bool)
    # set-only-True scatter: loc has duplicates (several ELL entries per
    # row, plus w=0 pads clipped to position 0) — put_along_axis would
    # let a later pad overwrite a real row's True
    sel = lw != 0
    flat = (np.arange(n_tiles)[:, None] * W_ + lc)[sel]
    used.reshape(-1)[flat] = True
    chunks = []
    pos_maps = np.zeros((n_tiles, W_), np.int64)
    for t in range(n_tiles):
        rows_t = np.asarray(slab_idx[t])
        u = used[t]
        # slab rows are sorted unique; runs = consecutive-row groups
        upos = np.nonzero(u)[0]
        ch_t = []
        if len(upos):
            rows = rows_t[upos]
            brk = np.nonzero(np.diff(rows) != 1)[0]
            starts = np.concatenate(([0], brk + 1))
            ends = np.concatenate((brk + 1, [len(rows)]))
            pm = np.zeros(W_, np.int64)
            for s0, e0 in zip(starts, ends):
                base = len(ch_t) * CH
                r0 = int(rows[s0])
                a0 = (r0 // CH) * CH          # aligned coverage start
                for a in range(a0, int(rows[e0 - 1]) + 1, CH):
                    ch_t.append(a // CH)
                pm[upos[s0:e0]] = base + (r0 - a0) + np.arange(e0 - s0)
            pos_maps[t] = pm
        chunks.append(ch_t)
    NC = max(1, max(len(c) for c in chunks))
    ch_src = np.zeros((n_tiles, NC), np.int32)
    for t, c in enumerate(chunks):
        ch_src[t, :len(c)] = c
    loc8 = np.take_along_axis(pos_maps, lc, axis=1)
    W8 = NC * CH
    ldt = np.uint8 if W8 <= 256 else (np.int16 if W8 <= 32767 else np.int32)
    return ch_src, loc8.astype(ldt), W8


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
    a thunk returning the (idx, w) K-concatenation, evaluated on a miss.
    One ``weights.pack`` span, loaded or built; a load counts as
    ``pack.cache_hits``, a build (a miss, or no cache) as
    ``pack.cache_misses``."""
    from ..diskcache import load_arrays, save_arrays

    with span("weights.pack"):
        path = None
        if cache_dir and ell_fps:
            os.makedirs(cache_dir, exist_ok=True)
            path = _pack_cache_path(cache_dir, ell_fps, ny, nx)
            hit = load_arrays(path)
            if hit is not None:
                try:
                    meta, arrs = hit
                    out = (arrs["slab_idx"], arrs["loc"], arrs["loc_w"],
                           int(meta["W"]), int(meta["nty"]),
                           int(meta["ntx"]), int(meta["n_tiles"]))
                    count("pack.cache_hits", 1)
                    return out
                except KeyError:
                    pass  # incomplete entry: rebuild
        count("pack.cache_misses", 1)
        idx, w = idx_w_fn()
        out = _pack_compact(_pack_union(idx, w, ny, nx, n_src))
        if path is not None:
            slab_idx, loc, loc_w, W, nty, ntx, n_tiles = out
            save_arrays(path, {"W": W, "nty": nty, "ntx": ntx,
                               "n_tiles": n_tiles},
                        {"slab_idx": slab_idx, "loc": loc, "loc_w": loc_w})
        return out


def _chunk_slab_cached(slab_idx, loc, loc_w, W, dst_shape, cache_dir=None,
                       ell_fps=None):
    """Disk-cached ``_chunk_slab`` -> (ch_src, loc8, W8), its own entry
    (``torchgather_``) beside the pack's, keyed like it. Computed only on
    the gather route's first use: it is a per-tile Python loop."""
    from ..diskcache import load_arrays, save_arrays

    path = None
    if cache_dir and ell_fps:
        os.makedirs(cache_dir, exist_ok=True)
        path = _pack_cache_path(cache_dir, ell_fps, *dst_shape).replace(
            "torchpack_", f"torchgather{CH}_")
        hit = load_arrays(path)
        if hit is not None:
            try:
                meta, arrs = hit
                return arrs["ch_src"], arrs["loc8"], int(meta["W8"])
            except KeyError:
                pass  # incomplete entry: rebuild
    ch_src, loc8, W8 = _chunk_slab(np.asarray(slab_idx), loc, loc_w, W)
    if path is not None:
        save_arrays(path, {"W8": W8}, {"ch_src": ch_src, "loc8": loc8})
    return ch_src, loc8, W8


def _src_window_to_device(src, lo, gw, device, pad_rows=0):
    """Packed columns [lo, lo + gw) of a host source -> (n_src + pad_rows,
    gw) f32 device tensor, zero past the data (and in the pad rows: the
    gather route's chunks may read CH rows past n_src). The full-width
    upload is the window [0, Cp).

    Accepts one (n_src, C) array OR a list of column blocks summing to C:
    each block is sliced to the window, converted and copied into a
    preallocated device buffer, so the host never materializes the
    concatenated matrix, and converts only the window's columns (the JAX
    package's copy converts the whole block first)."""
    blocks = src if isinstance(src, (list, tuple)) else [src]
    n_src = np.shape(blocks[0])[0]
    with span("apply.upload"):
        buf = torch.zeros((n_src + pad_rows, gw), dtype=torch.float32,
                          device=device)
        off = nbytes = 0
        for b in blocks:
            bw = 1 if np.ndim(b) == 1 else np.shape(b)[1]
            a, c = max(off, lo), min(off + bw, lo + gw)
            if a < c:
                win = (np.asarray(b)[:, None] if np.ndim(b) == 1
                       else b[:, a - off:c - off])
                win = np.ascontiguousarray(win, dtype=np.float32)
                buf[:n_src, a - lo:c - lo] = torch.from_numpy(win).to(device)
                nbytes += win.nbytes
            off += bw
    count("apply.upload_bytes", nbytes)
    return buf


def group_ranges(ranges, g, w):
    """The method column ``ranges`` that meet columns [g, g + w), relative
    to g: (sub-ranges, the methods' indices)."""
    sub, ms = [], []
    for m, (lo, hi) in enumerate(ranges):
        a, b = max(lo, g), min(hi, g + w)
        if a < b:
            sub.append((a - g, b - g))
            ms.append(m)
    return tuple(sub), ms


def device_budget(device, held=0) -> float:
    """Device bytes the grouped packed apply may fill, its operands
    (``held`` bytes, already on the device) included:
    ``MPASSIT_DEVICE_BUDGET_GB`` when set; else, on a CUDA device, ``held``
    plus FREE_SHARE of what the device can still give (its free bytes and
    the caching allocator's reserved but unallocated bytes, read now); on
    the CPU the JAX package's default of 12 GB."""
    env = os.environ.get("MPASSIT_DEVICE_BUDGET_GB")
    if env:
        return float(env) * 1e9
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
        cached = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return held + FREE_SHARE * float(free + cached)
    return 12e9


class _Staging:
    """The two host buffers through which every fetch from one device
    stages its row chunks, kept for the life of the process: page-locked
    on a CUDA device, whose copies into them run on ``stream`` beside the
    compute stream; plain host memory on the CPU, where the copies are
    immediate. ``lock`` keeps two threads' fetches off one pair."""

    def __init__(self, device):
        self.pinned = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.pinned else None
        self.bufs = ()
        self.lock = threading.Lock()

    def buffers(self, n):
        """The two flat float32 buffers, of at least ``n`` elements each;
        allocated again only when a chunk outgrows them."""
        if not self.bufs or self.bufs[0].numel() < n:
            self.bufs = tuple(torch.empty(n, dtype=torch.float32,
                                          pin_memory=self.pinned)
                              for _ in range(2))
        return self.bufs


_STAGING: dict = {}
_STAGING_LOCK = threading.Lock()


def _staging(device) -> _Staging:
    """The staging buffers of ``device``, made on its first fetch."""
    with _STAGING_LOCK:
        if device not in _STAGING:
            _STAGING[device] = _Staging(device)
        return _STAGING[device]


def _fetch_strips(o, C, ny, nx, lo0, root_only, out, strip_sink,
                  mesh=None):
    """Fetch columns [lo0, lo0 + o's width) ∩ [0, C) of a device result to
    the host: into ``out`` as one strip of all those columns, or to
    ``strip_sink`` in CB-column strips. A strip crosses in row chunks of
    at most FETCH_CHUNK bytes (every rank's part together) or one row,
    each copied from its strided slice into the device's staging buffers
    (``_Staging``) in turn, chunk k into buffer k mod 2. On a CUDA
    device the copies run on the side stream, after the work queued
    before the fetch, while the host scatters chunk k - 1 out of the other
    buffer; the side stream is drained before the fetch returns, so the
    caller may free ``o``.

    Under a ``mesh``, ``o`` is this rank's band of tile rows (grid rows
    [rank * band, (rank + 1) * band)): every rank takes the same row
    chunks of its band, each chunk is gathered from every rank
    (``gather_bands``: to all, or to rank 0 with ``root_only``, where the
    other ranks neither fill ``out`` nor call the sink) and each rank's
    rows land at its band's offset."""
    band = o.shape[0]
    world = 1 if mesh is None else mesh.world
    get = not (root_only and mesh is not None and mesh.rank != 0)
    n_rows = min(band, ny)          # rank 0's grid rows: the most of any
    hi = min(lo0 + o.shape[2], C)
    cw = CB if strip_sink is not None else hi - lo0
    st = _staging(o.device)

    def chunks():
        for lo in range(lo0, hi, cw):
            w = min(cw, hi - lo)
            strip = None
            if get:
                strip = (out[:, :, lo:lo + w] if strip_sink is None
                         else np.empty((ny, nx, w), np.float32))
            rows = max(1, FETCH_CHUNK // (world * 4 * nx * w))
            for r in range(0, n_rows, rows):
                yield (lo, w, strip, r, min(r + rows, n_rows),
                       r + rows >= n_rows)

    def land(lo, strip, r, parts, last, done):
        """Scatter a staged chunk, once its copy is ``done``, into its
        rows of the strip; hand a finished strip to the sink."""
        if done is not None:
            done.synchronize()
        n = 0
        for k in range(world):
            g0, g1 = k * band + r, min(k * band + r + parts.shape[1], ny)
            if g0 < g1:
                dst = strip[g0:g1]
                torch.from_numpy(dst).copy_(parts[k, :g1 - g0])
                n += dst.nbytes
        if last and strip_sink is not None:
            strip_sink(lo, strip)
        return n

    nbytes = 0
    with span("apply.fetch"), st.lock:
        bufs = st.buffers(max(FETCH_CHUNK // 4,
                              world * nx * cw))
        if st.pinned:
            st.stream.wait_stream(torch.cuda.current_stream(o.device))
        staged = None
        try:
            for k, (lo, w, strip, r, r1, last) in enumerate(chunks()):
                with torch.cuda.stream(st.stream):   # no-op on the CPU
                    part = gather_bands(
                        o[r:r1, :nx, lo - lo0:lo - lo0 + w], mesh,
                        root_only)
                    if strip is None:
                        continue
                    parts = bufs[k % 2][:part.numel()].view(part.shape)
                    parts.copy_(part, non_blocking=True)
                    done = (st.stream.record_event() if st.pinned
                            else None)
                if staged is not None:
                    nbytes += land(*staged)
                staged = (lo, strip, r, parts.unflatten(0, (world, r1 - r)),
                          last, done)
            if staged is not None:
                nbytes += land(*staged)
        finally:
            if st.pinned:
                st.stream.synchronize()
    count("apply.fetch_bytes", nbytes)
    count("apply.fetch_staged_bytes", nbytes if st.pinned else 0)


def _host_result(shape, root_only, mesh, strip_sink):
    """The host array an apply fills (``_fetch_strips``' ``out``): none
    with a strip sink; a zero broadcast view on a rank that gets nothing
    (root_only, not rank 0 of a mesh), as the JAX package returns."""
    if strip_sink is not None:
        return None
    if root_only and mesh is not None and mesh.rank != 0:
        return np.broadcast_to(np.float32(0.0), shape)
    return np.empty(shape, np.float32)


def _fetch_bytes(mesh, row_bytes=0) -> int:
    """Device bytes a fetch of strips whose rows are at most ``row_bytes``
    (one rank's) holds at most: its two row chunks in flight, each a
    contiguous device copy of every rank's part together, FETCH_CHUNK
    bytes or one row of every rank where that is more (``_fetch_strips``
    takes at least one row), and under a process group each chunk's own
    part too, made contiguous for the gather (gather_bands)."""
    world = 1 if mesh is None else mesh.world
    chunk = max(FETCH_CHUNK, world * row_bytes)
    if mesh is None or mesh.group is None:
        return 2 * chunk
    return 2 * (chunk + -(-chunk // world))


def padded(C) -> int:
    """C columns padded to the kernels' LANE-column blocks."""
    return C + (-C) % LANE


def column_ranges(cols) -> tuple:
    """Column counts -> the consecutive (lo, hi) ranges they take."""
    ends = tuple(itertools.accumulate(int(c) for c in cols))
    return tuple(zip((0,) + ends[:-1], ends))


class PackedSlabRegridder:
    """One or more ELL operators over the SAME source row space and target
    grid, tile-packed together and applied by the kernel of the route (see
    the module docstring), one launch per column group.

    The operator holds what depends only on ``ells``, the device and the
    mesh: the union pack (per tile the sorted union of the operators'
    unique source rows, ``slab_idx``, and each entry's local index into
    it), the route and its device operands (built on first use) and, with
    ``rotation`` ((cosa, sina) host arrays of the target grid), the
    rotation grid tile-blocked for the kernels. A call brings the data: a
    source whose columns are the methods' in ``ells`` order, ``cols`` of
    each (None: one operator, every column), and the Q4 wind rotation's
    windows ``rotate``, (cu, cv, n) packed-column triples (u levels at
    [cu, cu + n), v at [cv, cv + n)), applied inside the kernel on every
    route. A window that does not fit one 256-column sub-chunk of one
    method's range raises ValueError before anything is uploaded, as in
    the JAX package, so that both packages take the same rotation route.

    Raises ValueError when a tile references more than W_CAP unique
    source rows (the caller falls back to ops.apply.Regridder). With a
    ``mesh`` each rank applies its band of tile rows (see the module
    docstring): ``nty``/``ntx`` are the grid's tile rows and columns,
    ``nty_l`` the tile rows this rank launches over (``nty`` without a
    mesh), ``nty_p`` the padded total (``nty_l`` times the world size),
    ``n_tiles`` this rank's tiles (``nty_l * ntx``)."""

    #: apply_np accepts a list of column blocks (device-side assembly)
    accepts_blocks = True

    def __init__(self, ells, device, precision: str = "highest",
                 rotation=None, cache_dir=None, mesh=None):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        if len({e.n_src for e in ells}) != 1:
            raise ValueError("packed operators must share one source space")
        if len({tuple(e.dst_shape) for e in ells}) != 1:
            raise ValueError("packed operators must share the target grid")
        if len(ells[0].dst_shape) != 2:
            raise ValueError("PackedSlabRegridder needs a 2-D dst_shape")
        ny, nx = ells[0].dst_shape
        self.n_src = ells[0].n_src
        self.dst_shape = (ny, nx)
        self.precision = precision
        self.device = torch.device(device)
        self.cache_dir = cache_dir
        self.mesh = mesh
        #: "ell" (default), "onehot" or "gather", see _route_from_env; no
        #: gather route under a mesh
        self.route = _route_from_env()
        if mesh is not None and self.route == "gather":
            self.route = "ell"
        self._Ks = [e.idx.shape[1] for e in ells]
        self._fps = tuple(e.fingerprint() for e in ells) if cache_dir else None

        # union slab over the K-concatenation of all methods; per-method
        # loc/w slices over it follow the K-concatenation order
        def _cat():
            return (np.concatenate(
                        [np.asarray(e.idx, np.int64) for e in ells], axis=1),
                    np.concatenate(
                        [np.asarray(e.w, np.float64) for e in ells], axis=1))

        slab_idx, loc, loc_w, self.W, self.nty, self.ntx, _ = (
            _pack_union_cached(_cat, ny, nx, self.n_src, cache_dir=cache_dir,
                               ell_fps=self._fps))
        self.nty_l = self.nty if mesh is None else -(-self.nty // mesh.world)
        self.nty_p = self.nty_l * (1 if mesh is None else mesh.world)
        self.n_tiles = self.nty_l * self.ntx
        if mesh is not None:
            slab_idx, loc, loc_w = (band_rows(np.asarray(a), mesh,
                                              self.n_tiles)
                                    for a in (slab_idx, loc, loc_w))
        self._slab_idx_host = slab_idx
        self._loc_host, self._w_host = loc, loc_w
        self.slab_idx = torch.tensor(np.asarray(slab_idx).reshape(-1),
                                     device=self.device)
        self._locws = self._As = self._gather = None
        self.W8 = None

        # in-kernel wind rotation (quirk Q4): cosa/sina tile-blocked
        # (n_tiles, TY, TX) and padded with the IDENTITY rotation (cosa=1,
        # sina=0) outside the data region — zero padding would put 0/0
        # NaNs in the padded rows; this rank's band of tile rows
        self._cosa_t = self._sina_t = None
        if rotation is not None:
            cosa, sina = rotation
            cs = np.zeros((self.nty_p * TY, self.ntx * TX, 2), np.float32)
            cs[:, :, 0] = 1.0
            cs[:ny, :nx, 0] = np.asarray(cosa, np.float32).reshape(ny, nx)
            cs[:ny, :nx, 1] = np.asarray(sina, np.float32).reshape(ny, nx)
            t0 = (0 if mesh is None else mesh.rank) * self.n_tiles
            cs_t = _tile_block(cs, self.nty_p, self.ntx, 2).reshape(
                self.nty_p * self.ntx, TY, TX, 2)[t0:t0 + self.n_tiles]
            self._cosa_t = torch.from_numpy(
                np.ascontiguousarray(cs_t[..., 0])).to(self.device)
            self._sina_t = torch.from_numpy(
                np.ascontiguousarray(cs_t[..., 1])).to(self.device)

    def _ell_dev(self):
        """Per-method (n_tiles, K, TILE) loc/w device tensors."""
        if self._locws is None:
            with span("apply.operands"):
                self._locws = tuple(
                    _per_method(a, self.n_tiles, self._Ks, dt, self.device)
                    for a, dt in ((self._loc_host, np.int32),
                                  (self._w_host, np.float32)))
        return self._locws

    @property
    def As(self):
        """Per-method f32 one-hot operators (n_tiles, W, TILE) over the
        slab, built on the device on first use and kept (one-hot route)."""
        if self._As is None:
            with span("apply.operands"):
                loc3 = np.asarray(self._loc_host).reshape(
                    self.n_tiles, TILE, sum(self._Ks))
                w3 = np.asarray(self._w_host).reshape(loc3.shape)
                As, koff = [], 0
                for K in self._Ks:
                    loc_m, w_m = (
                        torch.tensor(a[:, :, koff:koff + K].reshape(-1, K),
                                     dtype=dt, device=self.device)
                        for a, dt in ((loc3, torch.int64),
                                      (w3, torch.float32)))
                    As.append(_build_A_T(loc_m, w_m, self.n_tiles, self.W))
                    koff += K
                self._As = As
        return self._As

    def _gather_dev(self):
        """(ch_src, locs8, ws) device tensors of the gather route; the
        chunked-run layout is computed (or loaded) on first use."""
        if self._gather is None:
            with span("apply.operands"):
                ch_src, loc8, self.W8 = _chunk_slab_cached(
                    self._slab_idx_host, self._loc_host, self._w_host,
                    self.W, self.dst_shape, cache_dir=self.cache_dir,
                    ell_fps=self._fps)
                self._gather = (
                    torch.tensor(np.asarray(ch_src), dtype=torch.int32,
                                 device=self.device),
                    _per_method(loc8, self.n_tiles, self._Ks, np.int32,
                                self.device),
                    _per_method(self._w_host, self.n_tiles, self._Ks,
                                np.float32, self.device))
        return self._gather

    @property
    def pad_rows(self) -> int:
        """Zero rows past n_src in an uploaded source: the CH rows the
        gather route's last chunks may read."""
        return CH if self.route == "gather" else 0

    def _slab(self, src_dev):
        """(n_src + pad_rows, Cp) -> (n_tiles, W, Cp): the one row gather."""
        return torch.index_select(src_dev, 0, self.slab_idx).view(
            self.n_tiles, self.W, src_dev.shape[1])

    def _kernel(self):
        """The route's kernel over its device operands, built here on first
        use: (launch, operands, slab rows). ``launch(src_dev, ms, **kw)``
        applies the methods ``ms`` to an (n_src + pad_rows, w) device
        window by one launch; the slab rows are what each tile stages from
        the source, W (W8 on the gather route). The one place that tells
        the routes apart, besides ``pad_rows``."""
        if self.route == "gather":
            ch, locs, ws = self._gather_dev()
            return (lambda src_dev, ms, **kw: packed_gather_apply(
                        src_dev, ch, [locs[m] for m in ms],
                        [ws[m] for m in ms], W8=self.W8, **kw),
                    (ch, *locs, *ws), self.W8)
        if self.route == "onehot":
            As = self.As
            return (lambda src_dev, ms, **kw: onehot_apply_packed(
                        [As[m] for m in ms], self._slab(src_dev),
                        precision=self.precision, **kw),
                    tuple(As), self.W)
        locs, ws = self._ell_dev()
        return (lambda src_dev, ms, **kw: packed_apply(
                    self._slab(src_dev), [locs[m] for m in ms],
                    [ws[m] for m in ms], **kw),
                (*locs, *ws), self.W)

    def _ranges(self, C, cols, rotate):
        """The methods' column ranges and the padded width Cp of a
        C-column source laid out as ``cols``, the rotation windows checked
        against them."""
        ranges = column_ranges([C] if cols is None else cols)
        if len(ranges) != len(self._Ks) or ranges[-1][1] != C:
            raise ValueError(
                f"source has {C} columns, the call gives {cols} for "
                f"{len(self._Ks)} packed operators")
        Cp = padded(C)
        if rotate:
            if self._cosa_t is None:
                raise ValueError("rotate windows need the operator built "
                                 "with a rotation grid")
            _validate_rotate(rotate, ranges, Cp)
        return ranges, Cp

    def _apply(self, src_dev, ranges, g=0, rotate=()):
        """(n_src + pad_rows, w) device window of packed source columns
        [g, g + w) -> (nyp, nxp, w) by one launch of the route's kernel,
        over the methods that meet the window with their column ranges
        relative to g; the rotation windows ride the window at g = 0.
        Columns past the last range are zeroed by the kernel."""
        sub, ms = group_ranges(ranges, g, src_dev.shape[1])
        kw = dict(ranges=sub, nty=self.nty_l, ntx=self.ntx)
        if g == 0:
            kw.update(rotate=tuple(rotate), cosa=self._cosa_t,
                      sina=self._sina_t)
        launch, _, rows = self._kernel()
        count("apply.slab_bytes",
              4 * self.n_tiles * rows * int(src_dev.shape[1]))
        return launch(src_dev, ms, **kw)

    def __call__(self, src_dev, cols=None, rotate=()):
        """src (n_src, C) tensor on the operator's device, columns laid
        out as ``cols``. Returns the (nyp, nxp, C) device result
        (tile-padded grid); under a mesh this rank's band of it,
        (nty_l * 32, nxp, C)."""
        if src_dev.dim() == 1:
            src_dev = src_dev[:, None]
        C = src_dev.shape[1]
        ranges, Cp = self._ranges(C, cols, rotate)
        src_dev = torch.nn.functional.pad(src_dev.float(),
                                          (0, Cp - C, 0, self.pad_rows))
        return self._apply(src_dev, ranges, rotate=rotate)[:, :, :C]

    def _held_bytes(self) -> int:
        """Device bytes of what each group's launch reads besides its
        source window: the slab index, the route's operands (``_kernel``,
        built here on first use) and the rotation's cosa/sina."""
        held = [self.slab_idx, self._cosa_t, self._sina_t,
                *self._kernel()[1]]
        return sum(t.numel() * t.element_size() for t in held
                   if t is not None)

    def _grouped_width(self, Cp, rotate=()) -> int:
        """Column-group width of the device-memory-bounded apply of Cp
        padded columns, or 0 when one full-width pass fits
        ``device_budget``. The JAX package's rule, with what it leaves out
        counted: a column costs its source, slab and output columns, all
        live during its group's launch; beside them the device holds the
        operands (``_held_bytes``) and a fetch (``_fetch_bytes``, its
        strips at most a group wide). From FETCH, the halving keeps two
        groups' worth of columns inside the rest, as in the JAX package.
        Group 0 keeps the ``rotate`` windows and at least CB columns, and
        the width is rounded up to a multiple of LANE, which the kernels'
        column blocks need: only these floors may take a group past the
        budget. Under a mesh a rank counts its band's slab and output, and
        every rank takes the least width any rank computed (their devices'
        free bytes may differ), so all run the same groups."""
        if Cp <= FETCH:
            return 0
        per_col = 4 * (self.n_src + self.n_tiles * self.W
                       + self.nty_l * TY * self.ntx * TX)
        held = self._held_bytes()
        room = device_budget(self.device, held) - held

        def need(w, n):
            """n groups' columns of width w and a fetch of w-wide strips."""
            return n * w * per_col + _fetch_bytes(
                self.mesh, 4 * self.dst_shape[1] * w)
        gw = 0
        if need(Cp, 1) > room:
            gw = FETCH
            while gw > LANE and need(gw, 2) > room:
                gw //= 2
            if rotate:
                gw = max(gw, CB, max(cv + n for (_, cv, n) in rotate))
            gw = -(-gw // LANE) * LANE
        if self.mesh is not None and self.mesh.group is not None:
            least = torch.tensor([gw or Cp], device=self.device)
            dist.all_reduce(least, op=dist.ReduceOp.MIN,
                            group=self.mesh.group)
            gw = int(least) if int(least) < Cp else 0
        return gw

    def apply_np(self, src, cols=None, rotate=(), root_only: bool = False,
                 strip_sink=None):
        """Host apply of ``src`` (one (n_src, C) array, a 1-D one for one
        column, or a list of column blocks summing to C), its columns laid
        out as ``cols`` with the rotation windows ``rotate``. In column
        groups of ``_grouped_width`` columns when one full-width pass
        would not fit the device budget, else in one group of Cp (always
        on the gather route, as in the JAX package). Per group: the source
        window's upload, one launch of the route's kernel (``_apply``) and
        the fetch (``_fetch_strips``); the group is freed before the next
        one is uploaded. Returns the (ny, nx, C) host result ((ny, nx) for
        a 1-D source); with ``strip_sink`` each fetched (ny, nx, cb) strip
        is handed to ``strip_sink(col_lo, strip)`` instead and None is
        returned."""
        is_blocks = isinstance(src, (list, tuple))
        blocks = src if is_blocks else [src]
        C = sum(1 if np.ndim(b) == 1 else np.shape(b)[1] for b in blocks)
        ranges, Cp = self._ranges(C, cols, rotate)
        gw = (Cp if self.route == "gather"
              else self._grouped_width(Cp, rotate) or Cp)
        ny, nx = self.dst_shape
        out = _host_result((ny, nx, C), root_only, self.mesh, strip_sink)
        for g in range(0, Cp, gw):
            count("apply.groups", 1)
            src_dev = _src_window_to_device(src, g, min(gw, Cp - g),
                                            self.device, self.pad_rows)
            o = self._apply(src_dev, ranges, g, rotate)
            del src_dev
            _fetch_strips(o, C, ny, nx, g, root_only, out, strip_sink,
                          self.mesh)
            del o
        if out is not None and not is_blocks and np.ndim(src) == 1:
            return out[:, :, 0]
        return out
