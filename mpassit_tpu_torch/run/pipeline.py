"""End-to-end batch pipeline (counterpart of mpassit_tpu/run/pipeline.py).

Sequence mirrors mpassit.F90:105-137: read namelist -> build target grid ->
ingest MPAS mesh -> read fields -> generate/cache weights -> apply on the
device -> wind fixups -> write WRF-compatible NetCDF. Method routing, the
quirks and the host layers (config, grids, mesh, weights, io) are the JAX
package's own, imported; only the device-bound layers are ported.

The device is explicit: ``run_pipeline(cfg, device)`` places every
operator and apply on ``device``; ``main`` takes it from
``MPASSIT_PLATFORM`` (``cuda`` by default, ``cpu`` for the tests). On a
CUDA device every packed and slab apply launches a Hopper kernel of the
apply route that ``MPASSIT_ELL_KERNEL``/``MPASSIT_GATHER_KERNEL`` pick
(ops/matmul_apply.py); on the CPU they run its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from mpassit_tpu.config import Config
from mpassit_tpu.constants import PROJ_LC
from mpassit_tpu.errors import FatalError
from mpassit_tpu.fields.registry import Routing, build_routing
from mpassit_tpu.grids.target import TargetGrid, build_target_grid
from mpassit_tpu.io.mpas_reader import (
    InputData,
    read_diag_data,
    read_hist_data,
)
from mpassit_tpu.io.wrf_writer import RegridResult, write_output
from mpassit_tpu.mesh.mpas import MPASMesh, mesh_from_file
from mpassit_tpu.weights.bilinear import (
    bilinear_cell_weights,
    bilinear_vertex_weights,
)
from mpassit_tpu.weights.cache import WeightCache, grid_fingerprint
from mpassit_tpu.weights.conservative import conservative_weights
from mpassit_tpu.weights.ell import ELLWeights
from mpassit_tpu.weights.nearest import nearest_weights
from mpassit_tpu.weights.restagger import edge1_weights, edge2_weights

from ..ops.apply import Regridder
from ..ops.matmul_apply import PackedSlabRegridder, SlabMatmulRegridder
from ..ops.rotate import check_rotation_angles, rotate_winds

log = logging.getLogger("mpassit_tpu")


@dataclasses.dataclass
class Timings:
    stages: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, dt: float):
        self.stages[name] = self.stages.get(name, 0.0) + dt


class _Timer:
    """Host wall clock of one stage; on a CUDA device the stage ends with
    a synchronize, so queued device work is charged to the stage that
    issued it."""

    def __init__(self, timings: Timings, name: str, device=None):
        self.t, self.name, self.device = timings, name, device

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *a):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t.add(self.name, time.perf_counter() - self.t0)
        log.info("- %s: %.3fs", self.name, self.t.stages[self.name])


def _nan_guard(name: str, arr) -> None:
    """MPASSIT_DEBUG_NANS=1: per-field invalid-value trap (the reference's
    -ffpe-trap debug-build analog, CMakeLists.txt:36)."""
    if os.environ.get("MPASSIT_DEBUG_NANS") == "1" and not np.isfinite(
            arr).all():
        raise FatalError(f"NON-FINITE VALUES IN REGRIDDED FIELD {name}")


def _unstack_specs(out, data: InputData, specs, nlevs):
    """Slice an applied (ny, nx, C) block back into per-field tuples."""
    res, off = [], 0
    for s, nl in zip(specs, nlevs):
        arr = out[..., off] if nl is None else out[..., off:off + nl]
        res.append((s.out_name, arr, data.units[s.in_name],
                    data.long_name[s.in_name]))
        off += 1 if nl is None else nl
    for name, arr, *_ in res:
        _nan_guard(name, arr)
    return res


class _StripRouter:
    """Maps an apply's fetched column strips to their consumers: variables
    stream straight into the output file (``writer.put``), parts that must
    stay in memory (mass winds for the restagger, U10/V10 awaiting
    rotation) fill small host buffers."""

    def __init__(self, writer, dst_shape):
        self.writer = writer
        self.dst_shape = dst_shape
        self.segs = []       # (c0, c1, var, nlev) streamed segments
        self.bufs = []       # (c0, c1, array, squeeze, sink)
        self.off = 0

    def add_stream(self, entries, defer=(), deferred=None):
        """entries: [(var, nlev_or_None)], consecutive columns. Vars in
        ``defer`` are buffered into ``deferred[var]`` instead of streamed."""
        for var, nlev in entries:
            k = 1 if nlev is None else nlev
            if var in defer:
                buf = np.empty(self.dst_shape + (k,), np.float32)
                deferred[var] = (buf, nlev)
                self.bufs.append((self.off, self.off + k, buf, False, None))
            else:
                self.segs.append((self.off, self.off + k, var, nlev))
            self.off += k

    def add_buffer(self, ncols, squeeze, sink):
        buf = np.empty(self.dst_shape + (ncols,), np.float32)
        self.bufs.append((self.off, self.off + ncols, buf, squeeze, sink))
        self.off += ncols

    def __call__(self, lo, strip):
        hi = lo + strip.shape[2]
        for c0, c1, var, nlev in self.segs:
            a, b = max(c0, lo), min(c1, hi)
            if a < b:
                blk = strip[:, :, a - lo:b - lo]
                if nlev is None:
                    blk = blk[:, :, 0]
                _nan_guard(var, blk)
                self.writer.put(var, a - c0, blk)
        for c0, c1, buf, _, _ in self.bufs:
            a, b = max(c0, lo), min(c1, hi)
            if a < b:
                buf[:, :, a - c0:b - c0] = strip[:, :, a - lo:b - lo]

    def finalize(self):
        for _, _, buf, squeeze, sink in self.bufs:
            if sink is not None:
                sink(buf[:, :, 0] if squeeze else buf)


class _ApplyBatch:
    """Cross-category bundle packing: every stack routed to the SAME weight
    operator joins one (n_src, C_total) apply; sinks run after the apply,
    in add() order. With a ``writer``, parts carrying ``stream`` entries
    write their fetched strips directly to the file (see _StripRouter)."""

    def __init__(self, rg, dtype, root_only: bool = False):
        self.rg, self.dtype = rg, dtype
        self.root_only = root_only
        self.parts = []   # (n_cols, src_matrix, squeeze, sink, tag, stream)

    def add(self, src, sink, tag=None, stream=None):
        """src (n_src,) or (n_src, k) — or a LIST of such per-field blocks
        (never concatenated on the host by the block-list engines); sink
        receives the (ny, nx, k) block (or (ny, nx) when src was 1-D).
        ``tag`` marks parts for the packed apply ("rot_u"/"rot_v" wind
        columns rotated in-kernel); ``stream`` = [(var, nlev)] routes the
        part's columns straight to the output file in streaming mode."""
        if isinstance(src, list):
            n = sum(1 if b.ndim == 1 else b.shape[1] for b in src)
            self.parts.append((n, src, False, sink, tag, stream))
            return
        squeeze = src.ndim == 1
        mat = src[:, None] if squeeze else src
        self.parts.append((mat.shape[1], mat, squeeze, sink, tag, stream))

    def add_stack(self, data: InputData, specs, ndim: int, sink):
        """Pack a varlist category; sink receives [(name, arr, units,
        long_name)] in spec order."""
        if not specs:
            sink([])
            return
        if ndim == 2:
            nlevs = [None] * len(specs)
        else:
            nlevs = [data.fields[s.in_name].shape[1] for s in specs]
        self.add([data.fields[s.in_name] for s in specs], lambda out: sink(
            _unstack_specs(out, data, specs, nlevs)),
            stream=[(s.out_name, nl) for s, nl in zip(specs, nlevs)])

    #: vars buffered for post-apply handling in streaming mode (U10/V10
    #: awaiting rotation); results land in ``deferred``
    defer: frozenset = frozenset()

    def run(self, writer=None, deferred=None):
        if not self.parts:
            return
        src = []
        for _, m, _, _, _, _ in self.parts:
            src.extend(m if isinstance(m, list) else [m])
        if not getattr(self.rg, "accepts_blocks", False):
            # gather engines take one host matrix
            src = np.concatenate(
                [b[:, None] if b.ndim == 1 else b for b in src],
                axis=1).astype(self.dtype)
        if writer is None:
            out = self.rg.apply_np(src, root_only=self.root_only)
            off = 0
            for k, _, squeeze, sink, _, _ in self.parts:
                sink(out[..., off] if squeeze else out[..., off:off + k])
                off += k
        else:
            router = _StripRouter(writer, self.rg.dst_shape)
            for k, _, squeeze, sink, _, stream in self.parts:
                if stream is not None:
                    router.add_stream(stream, defer=self.defer,
                                      deferred=deferred)
                else:
                    router.add_buffer(k, squeeze, sink)
            if getattr(self.rg, "accepts_blocks", False):
                self.rg.apply_np(src, root_only=self.root_only,
                                 strip_sink=router)
            else:
                # gather engines can't stream strips: materialize, then
                # route the whole block once
                router(0, self.rg.apply_np(src, root_only=self.root_only))
            router.finalize()
        self.parts = []


def _run_batches_packed(batches, rgs, weights, root_only, device,
                        grid=None) -> bool:
    """Cross-METHOD packing: when the cell-space methods (bilinear /
    nearest / conserve) all ride SlabMatmulRegridder engines, fuse their
    batches into ONE PackedSlabRegridder apply — one union-slab gather and
    one kernel launch for every cell-located field in the run. Drained
    batches are emptied; anything unpacked (vertex space, f64 engines)
    runs normally afterwards. MPASSIT_NO_PACK=1 disables (test hook).

    Parts tagged "rot_u"/"rot_v" (the mass winds under Lambert) are moved
    to the FRONT of the bilinear column range and the Q4 earth->grid
    rotation runs INSIDE the kernel — their sinks receive rotated winds.
    Returns True when that in-kernel rotation was performed."""
    if os.environ.get("MPASSIT_NO_PACK") == "1":
        return False
    cell_keys = [k for k in ("bilinear", "nearest", "conserve")
                 if k in batches and batches[k].parts]
    if len(cell_keys) < 2 or not all(
            isinstance(rgs[k], SlabMatmulRegridder) for k in cell_keys):
        return False

    # in-kernel wind rotation: pull the tagged u/v parts to the head of the
    # bilinear range so their window sits in the first 256-column chunk
    rotate_spec = None
    if grid is not None and "bilinear" in cell_keys:
        bparts = batches["bilinear"].parts
        tagged = {p[4]: i for i, p in enumerate(bparts)
                  if p[4] in ("rot_u", "rot_v")}
        if set(tagged) == {"rot_u", "rot_v"}:
            iu, iv = tagged["rot_u"], tagged["rot_v"]
            n_u, n_v = bparts[iu][0], bparts[iv][0]
            if n_u == n_v:
                rest = [p for i, p in enumerate(bparts) if i not in (iu, iv)]
                batches["bilinear"].parts = [bparts[iu], bparts[iv]] + rest
                rotate_spec = (((0, n_u, n_u),), grid.cosa, grid.sina)
    ref_rg = rgs[cell_keys[0]]
    ells_and_cols = [(weights[k], sum(p[0] for p in batches[k].parts))
                     for k in cell_keys]
    pk = None
    if rotate_spec is not None:
        try:
            pk = PackedSlabRegridder(
                ells_and_cols, device, precision=ref_rg.precision,
                rotate_spec=rotate_spec, cache_dir=ref_rg.cache_dir)
        except ValueError:
            pk = None          # window exceeds the 256-column chunk: rotate
            rotate_spec = None  # post-hoc instead
    if pk is None:
        try:
            pk = PackedSlabRegridder(
                ells_and_cols, device, precision=ref_rg.precision,
                cache_dir=ref_rg.cache_dir)
        except ValueError:
            return False             # e.g. union exceeds the W cap
    # list of per-part column blocks, assembled on the device
    src = []
    for k in cell_keys:
        for _, m, _, _, _, _ in batches[k].parts:
            src.extend(m if isinstance(m, list) else [m])
    log.info("- packed apply: %s (%d cols, one kernel pass%s)",
             "+".join(cell_keys), pk.C_total,
             ", in-kernel wind rotation" if rotate_spec else "")
    out = pk.apply_np(src, root_only=root_only)
    off = 0
    for k in cell_keys:
        b = batches[k]
        for kcols, _, squeeze, sink, _, _ in b.parts:
            sink(out[..., off] if squeeze else out[..., off:off + kcols])
            off += kcols
        b.parts = []
    return rotate_spec is not None


def _stack_apply(rg, data: InputData, specs, ndim: int, dtype=np.float32,
                 root_only: bool = False):
    """One-shot bundle apply (per-field conservative regrids,
    interp_as_bundle=.false.). Returns [(out_name, arr, units, desc)]."""
    batch = _ApplyBatch(rg, dtype, root_only=root_only)
    res = []
    batch.add_stack(data, specs, ndim, res.extend)
    batch.run()
    return res


def _make_regridder(ell: ELLWeights, dtype, device, precision="highest",
                    cache_dir=None):
    """Pick the apply engine: the tile-packed kernel engine for f32 2-D
    grids, falling back to the plain gather Regridder for f64 runs, 1-D
    targets, or tiles over W_CAP."""
    if dtype == torch.float32 and len(ell.dst_shape) == 2:
        try:
            return SlabMatmulRegridder(ell, device, precision=precision,
                                       cache_dir=cache_dir)
        except ValueError:
            pass
    return Regridder(ell, device, dtype=dtype)


@dataclasses.dataclass
class PipelineArtifacts:
    """Intermediate state, exposed for tests/benchmarks."""

    cfg: Config
    grid: TargetGrid
    mesh: MPASMesh
    routing: Routing
    data: InputData
    result: RegridResult
    regridders: dict
    timings: Timings


def build_weights(cfg: Config, mesh: MPASMesh, grid: TargetGrid,
                  routing: Routing) -> dict:
    """Generate (or load cached) every weight set the routing needs."""
    cache = WeightCache(cfg.weights_cache_dir)
    fpm, fpg = mesh.fingerprint(), grid_fingerprint(grid)
    out: dict[str, ELLWeights] = {}

    def get(tag, builder):
        return cache.get_or_build(tag, fpm, fpg, builder)

    out["bilinear"] = get(
        "bilinear", lambda: bilinear_cell_weights(mesh, grid.lat, grid.lon))
    if routing.nstd_2d or routing.soil_method() == "nearest":
        out["nearest"] = get(
            "nearest", lambda: nearest_weights(mesh, grid.lat, grid.lon))
    if routing.cons_2d or routing.soil_method() == "conserve":
        out["conserve"] = get(
            "conserve", lambda: conservative_weights(mesh, grid))
    if routing.vert_3d:
        out["vertex"] = get(
            "vertex", lambda: bilinear_vertex_weights(mesh, grid.lat, grid.lon))
    # center -> edge-stagger spherical bilinear (interp.F90:295-328);
    # depends only on the target grid (mesh_fp kept for a uniform key layout)
    if routing.do_u:
        out["edge1"] = get("edge1", lambda: edge1_weights(grid))
    if routing.do_v:
        out["edge2"] = get("edge2", lambda: edge2_weights(grid))
    return out


def _check_ported(cfg: Config) -> None:
    """Options of the JAX package that this package does not run yet:
    raise rather than silently ignore them."""
    todo = []
    if cfg.stream_output:
        todo.append("stream_output=.true. (ROADMAP.md queue 1, item 4)")
    if cfg.n_device_shards not in (0, 1):
        todo.append(f"n_device_shards={cfg.n_device_shards} "
                    "(ROADMAP.md queue 1, item 8)")
    if cfg.source_decomp != "replicate":
        todo.append(f"source_decomp={cfg.source_decomp!r} "
                    "(ROADMAP.md queue 1, item 8)")
    if os.environ.get("MPASSIT_PROFILE"):
        todo.append("MPASSIT_PROFILE (ROADMAP.md queue 1, item 9)")
    if todo:
        raise NotImplementedError(
            "not ported to mpassit_tpu_torch yet: " + "; ".join(todo))


def run_pipeline(cfg: Config, device, dtype=None) -> PipelineArtifacts:
    """Run the whole regrid on ``device`` (a torch.device or its name).
    ``dtype`` defaults to the namelist's compute_dtype."""
    _check_ported(cfg)
    device = torch.device(device)
    if dtype is None:
        dtype = (torch.float64 if cfg.compute_dtype == "float64"
                 else torch.float32)
    return _run_pipeline(cfg, device, dtype)


def _run_pipeline(cfg: Config, device, dtype) -> PipelineArtifacts:
    timings = Timings()

    def timer(name):
        return _Timer(timings, name, device)

    with timer("define_target_grid"):
        grid = build_target_grid(cfg)
    with timer("define_input_grid"):
        mesh = mesh_from_file(cfg.grid_file_input_grid)

    routing = build_routing(cfg.varlist_dir, cfg.interp_diag,
                            cfg.interp_hist, cfg.wrf_mod_vars)
    if not cfg.interp_diag and not cfg.interp_hist:
        # input_data.F90:114 error_handler message, verbatim
        raise FatalError(
            "SET INTERP_DIAG AND/OR INTERP_HIST TO TRUE TO OBTAIN OUTPUT")

    data = InputData()
    # ingest dtype: f32 unless the strict -r8 analog is requested
    in_dtype = (np.float64
                if dtype == torch.float64 or cfg.compute_dtype == "float64"
                else np.float32)
    with timer("read_input_data"):
        if cfg.interp_diag:
            read_diag_data(cfg.diag_file_input_grid, routing, data,
                           cfg.interp_hist, dtype=in_dtype)
        if cfg.interp_hist:
            read_hist_data(cfg.hist_file_input_grid, routing, data,
                           dtype=in_dtype)

    # Reference parity: block_decomp_file is validated when provided
    # (model_grid.F90:437); it decomposes nothing here.
    if cfg.block_decomp_file != "NULL":
        from mpassit_tpu.parallel.decomp import read_block_decomp_file

        read_block_decomp_file(cfg.block_decomp_file, mesh.ncells)

    # Input/grid dim consistency: a field sized for a different mesh would
    # misindex the weight apply (utils.F90:16-33 fail-fast contract).
    for name, arr in data.fields.items():
        n_expect = (mesh.nvertices
                    if any(s.in_name == name for s in routing.vert_3d)
                    else mesh.ncells)
        if arr.shape[0] != n_expect:
            raise FatalError(
                f"FIELD {name} HAS {arr.shape[0]} CELLS BUT THE MPAS GRID "
                f"FILE HAS {n_expect}")
    for wname, warr in (("uReconstructZonal", data.u),
                        ("uReconstructMeridional", data.v)):
        if warr is not None and warr.shape[0] != mesh.ncells:
            raise FatalError(
                f"FIELD {wname} HAS {warr.shape[0]} CELLS BUT THE MPAS GRID "
                f"FILE HAS {mesh.ncells}")

    # cell_order='morton': renumber source cells along a Z-curve over the
    # target's index space BEFORE weight generation, so each target tile's
    # slab gather reads a compact span of source rows; vertex-located
    # fields keep their vertex numbering. Results are unchanged.
    if cfg.cell_order == "morton":
        from mpassit_tpu.mesh.reorder import (
            apply_perm,
            reorder_cells_by_latitude,
            reorder_cells_morton,
        )

        ro = (reorder_cells_morton(mesh, grid.proj)
              if grid.proj is not None else reorder_cells_by_latitude(mesh))
        mesh = ro.mesh
        vert_names = {s.in_name for s in routing.vert_3d}
        for k in list(data.fields):
            if k not in vert_names:
                data.fields[k] = apply_perm(data.fields[k], ro.perm)
        if data.u is not None:
            data.u = apply_perm(data.u, ro.perm)
        if data.v is not None:
            data.v = apply_perm(data.v, ro.perm)

    with timer("weight_generation"):
        weights = build_weights(cfg, mesh, grid, routing)
        rgs = {k: _make_regridder(v, dtype, device,
                                  precision=cfg.apply_precision,
                                  cache_dir=cfg.weights_cache_dir)
               for k, v in weights.items()}

    res = RegridResult(nz=mesh.nz, nzp1=mesh.nzp1, nsoil=mesh.nsoil)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    def on_device(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    with timer("interp_data"):
        # one _ApplyBatch per weight operator: every stack routed to the
        # same method rides one slab gather + one kernel launch
        batches: dict[str, _ApplyBatch] = {}
        root_only = cfg.fetch_root_only

        def batch_for(key: str) -> _ApplyBatch:
            if key not in batches:
                batches[key] = _ApplyBatch(rgs[key], np_dtype,
                                           root_only=root_only)
            return batches[key]

        # wind mass fields feed the restagger: always fetched in full
        wind_batch = _ApplyBatch(rgs["bilinear"], np_dtype, root_only=False)
        # degeneracy guard (register R11): warn before any Q4 rotation if
        # the grid's rotation angles approach 90 deg (|cosa| -> 0)
        if cfg.proj_code == PROJ_LC and grid.cosa is not None:
            check_rotation_angles(grid.cosa)
        wind = {}
        d2 = []
        if cfg.interp_diag:
            d2 = [s for s in routing.diag if data.fields[s.in_name].ndim == 1]
            d3 = [s for s in routing.diag if data.fields[s.in_name].ndim == 2]
            batch_for("bilinear").add_stack(
                data, d2, 2, lambda r: setattr(res, "diag2d", r))
            batch_for("bilinear").add_stack(
                data, d3, 3, lambda r: setattr(res, "diag3d", r))

        if cfg.interp_hist:
            bil = batch_for("bilinear")
            bil.add_stack(data, routing.patch_2d, 2,
                          lambda r: setattr(res, "patch2d", r))
            bil.add_stack(data, routing.nz_3d, 3,
                          lambda r: setattr(res, "nz3d", r))
            bil.add_stack(data, routing.nzp1_3d, 3,
                          lambda r: setattr(res, "nzp13d", r))
            if routing.vert_3d:
                batch_for("vertex").add_stack(
                    data, routing.vert_3d, 3,
                    lambda r: setattr(res, "vert3d", r))
            if routing.cons_2d:
                if cfg.interp_as_bundle:
                    batch_for("conserve").add_stack(
                        data, routing.cons_2d, 2,
                        lambda r: setattr(res, "cons2d", r))
                else:
                    # interp_as_bundle=.false.: conservative fields
                    # regridded one at a time (interp.F90:368-416)
                    res.cons2d = [
                        one
                        for s in routing.cons_2d
                        for one in _stack_apply(rgs["conserve"], data, [s], 2,
                                                np_dtype,
                                                root_only=root_only)
                    ]
            if routing.nstd_2d:
                batch_for("nearest").add_stack(
                    data, routing.nstd_2d, 2,
                    lambda r: setattr(res, "nstd2d", r))
            if routing.soil:
                # quirk Q3: soil joins whatever method's batch the carryover
                # picked — with default lists the nstd nearest apply
                batch_for(routing.soil_method()).add_stack(
                    data, routing.soil, 3, lambda r: setattr(res, "soil", r))
            # staggered winds, first hop: mesh -> mass points
            # (interp.F90:256-289), packed into the bilinear bundle unless
            # terminal fields are root-only. Under Lambert the parts carry
            # rot tags so the packed apply rotates them in-kernel (Q4).
            wb = wind_batch if root_only else bil
            rot_lc = (routing.do_u and routing.do_v
                      and cfg.proj_code == PROJ_LC and wb is bil)
            if routing.do_u:
                wb.add(data.u, lambda a: wind.__setitem__("u", a),
                       tag="rot_u" if rot_lc else None)
            if routing.do_v:
                wb.add(data.v, lambda a: wind.__setitem__("v", a),
                       tag="rot_v" if rot_lc else None)

        # hgt always regridded when hist (interp.F90:226-238); for
        # diag-only runs without a target-file HGT the mesh 'ter' is
        # regridded instead of writing an uninitialized field
        if cfg.interp_hist or grid.hgt is None:
            batch_for("bilinear").add(
                mesh.ter, lambda a: setattr(res, "hgt", a),
                stream=[("HGT", None)])
        else:
            res.hgt = grid.hgt

        winds_rotated = _run_batches_packed(batches, rgs, weights,
                                            root_only, device, grid=grid)
        for b in batches.values():
            b.run()
        wind_batch.run()

        if cfg.interp_diag:
            # 10-m wind rotation (interp.F90:138-140, wind_dim=2)
            names2 = [s.in_name for s in d2]
            if "u10" in names2 and "v10" in names2 and cfg.proj_code == PROJ_LC:
                iu, iv = names2.index("u10"), names2.index("v10")
                u, v = rotate_winds(
                    torch.as_tensor(res.diag2d[iu][1], device=device),
                    torch.as_tensor(res.diag2d[iv][1], device=device),
                    on_device(grid.cosa), on_device(grid.sina))
                res.diag2d[iu] = (res.diag2d[iu][:1] + (u.cpu().numpy(),)
                                  + res.diag2d[iu][2:])
                res.diag2d[iv] = (res.diag2d[iv][:1] + (v.cpu().numpy(),)
                                  + res.diag2d[iv][2:])

        if cfg.interp_hist:
            # staggered winds (interp.F90:256-328, quirks Q4/Q6); skipped
            # when the packed apply already rotated them in-kernel
            umass, vmass = wind.get("u"), wind.get("v")
            if (routing.do_u and routing.do_v and cfg.proj_code == PROJ_LC
                    and not winds_rotated):
                u, v = rotate_winds(torch.as_tensor(umass, device=device),
                                    torch.as_tensor(vmass, device=device),
                                    on_device(grid.cosa),
                                    on_device(grid.sina))
                umass, vmass = u.cpu().numpy(), v.cpu().numpy()

            # center -> EDGE1/EDGE2 spherical bilinear regrid (quirk Q6,
            # interp.F90:295-328) through the same apply engines
            def restagger(key, mass):
                return rgs[key].apply_np(mass.reshape(grid.n_points, -1),
                                         root_only=root_only)

            if routing.do_u:
                res.u = restagger("edge1", umass)
            if routing.do_v:
                res.v = restagger("edge2", vmass)
        res.zs = mesh.zs

    # test hook: dump the full-precision regrid results before the f32
    # NetCDF write (the file caps agreement at f32 rounding)
    dump = os.environ.get("MPASSIT_DUMP_RESULT")
    if dump:
        arrs = {}
        for cat in ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d",
                    "vert3d", "cons2d", "nstd2d", "soil"):
            for name, arr, *_ in getattr(res, cat, None) or []:
                arrs[f"{cat}.{name}"] = arr
        for name in ("u", "v", "hgt"):
            if getattr(res, name, None) is not None:
                arrs[name] = getattr(res, name)
        np.savez(dump, **arrs)

    with timer("write_to_file"):
        write_output(cfg.output_file, cfg, grid, data, res)

    return PipelineArtifacts(cfg=cfg, grid=grid, mesh=mesh, routing=routing,
                             data=data, result=res, regridders=rgs,
                             timings=timings)


def resolve_device(platform: str) -> torch.device:
    """MPASSIT_PLATFORM value -> torch.device. ``cuda`` requires a CUDA
    device and never falls back to the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise FatalError(
                "MPASSIT_PLATFORM=cuda BUT NO CUDA DEVICE IS AVAILABLE "
                "(set MPASSIT_PLATFORM=cpu to run on the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    raise FatalError(
        f"MPASSIT_PLATFORM={platform!r}: EXPECTED 'cuda' OR 'cpu'")


def main(argv=None) -> int:
    import sys

    from ..parallel.multihost import maybe_init_distributed

    argv = sys.argv[1:] if argv is None else argv
    nml = argv[0] if argv else "./fort.41"  # mpassit.F90:52-65 default
    maybe_init_distributed()
    try:
        device = resolve_device(os.environ.get("MPASSIT_PLATFORM", "cuda"))
        # mpassit.F90:55-65: abort when the namelist path does not exist
        if not os.path.exists(nml):
            raise FatalError(f"namelist file - {nml} does not exist.")
        cfg = Config.from_namelist(nml)
        # esmf_log maps to verbose logging (the reference's ESMF PET error
        # logs, program_setup.F90:139-143)
        logging.basicConfig(
            level=logging.DEBUG if cfg.esmf_log else logging.INFO,
            format="%(message)s")
        run_pipeline(cfg, device)
    except FatalError as e:
        # error_handler/netcdf_err banner + abort (utils.F90:16-58); exit
        # code 999 truncates to 231 like mpi_abort's shell status
        print(e.banner(), file=sys.stderr)
        return 999 & 0xFF
    log.info("- DONE.")
    return 0
