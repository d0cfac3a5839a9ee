"""End-to-end batch pipeline (counterpart of mpassit_tpu/run/pipeline.py).

Sequence mirrors mpassit.F90:105-137: read namelist -> build target grid ->
ingest MPAS mesh -> read fields -> generate/cache weights -> apply on the
device -> wind fixups -> write WRF-compatible NetCDF, at the end or, with
``stream_output``, strip by strip as the applies fetch them (the host then
never holds the whole output). Method routing, the
quirks and the host layers (config, grids, mesh, weights, io) are copies
of the JAX package's, kept in this package with the same cache key and
file format; the device-bound layers are ported.

The device is explicit: ``run_pipeline(cfg, device)`` places every
operator and apply on ``device``; ``main`` takes it from
``MPASSIT_PLATFORM`` (``cuda`` by default, ``cpu`` for the tests). On a
CUDA device every tile-packed apply launches a Hopper kernel of the
apply route that ``MPASSIT_ELL_KERNEL``/``MPASSIT_GATHER_KERNEL`` pick
(ops/matmul_apply.py); on the CPU they run its plain PyTorch version.

Every call records its spans and counters (``spans.Timings``, the
artifacts' ``timings``): the eight top-level stages, and inside them the
spans the weights, apply and writer modules open. ``MPASSIT_PROFILE=<dir>``
(counterpart of the JAX package's ``jax.profiler.trace``) also records the
call with ``torch.profiler``: host activity of every thread, and the
device's on a CUDA device, each span a ``record_function`` event; the
Chrome trace lands in ``<dir>`` as ``trace_<pid>_<n>.json``, the n-th
profiled call of the process (``tools/trace_summary.py`` reads it).

Multi-process runs (parallel/multihost.py): ``main`` resolves the device
first (``cuda:LOCAL_RANK``, or the CPU), then starts the process group
over NCCL or gloo from the ``MPASSIT_*`` variables or a torchrun launch.
``n_device_shards = -1`` (or the world size) shards every apply over the
ranks (``_device_mesh``, ``_make_regridder``); every rank runs the same
program, rank 0 writes the file, and a streamed run's other ranks drop
their strips into a ``NullStreamWriter``.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os

import numpy as np
import torch

from ..config import Config
from ..constants import PROJ_LC
from ..errors import FatalError
from ..fields.registry import Routing, build_routing
from ..grids.target import TargetGrid, build_target_grid
from ..io.mpas_reader import (
    InputData,
    read_diag_data,
    read_hist_data,
)
from ..io.wrf_writer import (
    NullStreamWriter,
    RegridResult,
    StreamingWriter,
    write_output,
)
from ..mesh.mpas import MPASMesh, mesh_from_file
from ..mesh.reorder import (
    ReorderedMesh,
    apply_perm,
    reorder_cells_by_latitude,
    reorder_cells_morton,
)
from ..weights.bilinear import (
    bilinear_cell_weights,
    bilinear_vertex_weights,
)
from ..weights.cache import WeightCache, grid_fingerprint
from ..weights.conservative import conservative_weights
from ..weights.ell import ELLWeights
from ..weights.nearest import nearest_weights
from ..weights.restagger import (
    edge1_weights,
    edge2_weights,
    with_pole_rows,
    wrapped_points,
)

from ..ops.apply import Regridder
from ..ops.matmul_apply import PackedSlabRegridder, column_ranges
from ..ops.packed_kernel import _validate_rotate
from ..ops.rotate import check_rotation_angles, rotate_winds
from ..parallel.multihost import (
    is_primary,
    local_device_index,
    maybe_init_distributed,
    shutdown_distributed,
)
from ..parallel.sharding import (
    ShardedRegridder,
    SourceShardedRegridder,
    make_grid_mesh,
)
from ..spans import Timings, count, recording, span

log = logging.getLogger("mpassit_tpu_torch")


class _Timer(span):
    """A top-level stage: a span, logged with its seconds so far. The six
    stages of the reference's sequence end, on a CUDA device, with a
    synchronize (``device``), so queued device work is charged to the
    stage that issued it; the host-only stages take none."""

    def __init__(self, timings: Timings, name: str, device=None):
        super().__init__(name, sync=device)
        self.t = timings

    def __exit__(self, *a):
        super().__exit__(*a)
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

    def add_parts(self, parts, defer, deferred):
        """An _ApplyBatch's parts, in column order: streamed where they
        carry ``stream`` entries, buffered for their sinks otherwise."""
        for k, _, squeeze, sink, _, stream in parts:
            if stream is not None:
                self.add_stream(stream, defer=defer, deferred=deferred)
            else:
                self.add_buffer(k, squeeze, sink)

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
    write their fetched strips directly to the file (see _StripRouter).

    ``perm`` (mesh/reorder's, data_new = data_old[perm]) marks sources
    added in file order for an operator built on the renumbered cells.
    An operator that renumbers its uploads (``perm_inv``) takes them as
    they are; any other is handed them permuted on the host
    (``reorder.host_bytes``)."""

    def __init__(self, rg, dtype, root_only: bool = False, perm=None):
        self.rg, self.dtype = rg, dtype
        self.root_only = root_only
        self.perm = perm
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
        if (self.perm is not None
                and getattr(self.rg, "perm_inv", None) is None):
            src = [apply_perm(b, self.perm) for b in src]
            count("reorder.host_bytes", sum(b.nbytes for b in src))
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
            router.add_parts(self.parts, self.defer, deferred)
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
                        grid=None, writer=None, deferred=None) -> bool:
    """Cross-METHOD packing: when the cell-space methods (bilinear /
    nearest / conserve) all ride PackedSlabRegridder engines, fuse their
    batches into ONE apply of a PackedSlabRegridder over their union —
    one union-slab gather and one kernel launch for every cell-located
    field in the run (one per column group when the apply is grouped).
    Drained batches are emptied; anything unpacked (vertex space, f64
    engines) runs normally afterwards. MPASSIT_NO_PACK=1 disables (test
    hook). With a ``writer`` the fetched strips stream to it through a
    _StripRouter.

    Parts tagged "rot_u"/"rot_v" (the mass winds under Lambert) are moved
    to the FRONT of the bilinear column range and the Q4 earth->grid
    rotation runs INSIDE the kernel — their sinks receive rotated winds —
    when that window fits one 256-column chunk (``_validate_rotate``, the
    JAX package's check). Returns True when that in-kernel rotation was
    performed."""
    if os.environ.get("MPASSIT_NO_PACK") == "1":
        return False
    cell_keys = [k for k in CELL_KEYS if k in batches and batches[k].parts]
    if len(cell_keys) < 2 or not all(
            isinstance(rgs[k], PackedSlabRegridder) for k in cell_keys):
        return False
    cols = [sum(p[0] for p in batches[k].parts) for k in cell_keys]

    # in-kernel wind rotation: pull the tagged u/v parts to the head of the
    # bilinear range so their window sits in the first 256-column chunk
    rotate = ()
    if grid is not None and "bilinear" in cell_keys:
        bparts = batches["bilinear"].parts
        tagged = {p[4]: i for i, p in enumerate(bparts)
                  if p[4] in ("rot_u", "rot_v")}
        if set(tagged) == {"rot_u", "rot_v"}:
            iu, iv = tagged["rot_u"], tagged["rot_v"]
            n_u, n_v = bparts[iu][0], bparts[iv][0]
            if n_u == n_v:
                try:
                    _validate_rotate(((0, n_u, n_u),), column_ranges(cols),
                                     sum(cols))
                    rotate = ((0, n_u, n_u),)
                except ValueError:
                    pass     # window exceeds the chunk: rotate post-hoc
                rest = [p for i, p in enumerate(bparts) if i not in (iu, iv)]
                batches["bilinear"].parts = [bparts[iu], bparts[iv]] + rest
    ref_rg = rgs[cell_keys[0]]
    try:
        pk = PackedSlabRegridder(
            [weights[k] for k in cell_keys], device,
            precision=ref_rg.precision,
            rotation=(grid.cosa, grid.sina) if rotate else None,
            cache_dir=ref_rg.cache_dir, mesh=ref_rg.mesh,
            perm_inv=ref_rg.perm_inv)
    except ValueError:
        return False             # e.g. union exceeds the W cap
    # list of per-part column blocks, assembled on the device
    src = []
    for k in cell_keys:
        for _, m, _, _, _, _ in batches[k].parts:
            src.extend(m if isinstance(m, list) else [m])
    log.info("- packed apply: %s (%d cols, one kernel pass%s%s)",
             "+".join(cell_keys), sum(cols),
             ", in-kernel wind rotation" if rotate else "",
             ", streamed to file" if writer is not None else "")
    if writer is not None:
        router = _StripRouter(writer, pk.dst_shape)
        for k in cell_keys:
            router.add_parts(batches[k].parts, batches[k].defer, deferred)
            batches[k].parts = []
        pk.apply_np(src, cols, rotate, root_only=root_only,
                    strip_sink=router)
        router.finalize()
        return bool(rotate)
    out = pk.apply_np(src, cols, rotate, root_only=root_only)
    off = 0
    for k in cell_keys:
        b = batches[k]
        for kcols, _, squeeze, sink, _, _ in b.parts:
            sink(out[..., off] if squeeze else out[..., off:off + kcols])
            off += kcols
        b.parts = []
    return bool(rotate)


def _build_stream_plan(cfg, routing, data) -> dict:
    """Per-category (out_name, units, desc) lists for StreamingWriter:
    the schema the in-memory path derives from RegridResult, known before
    any apply runs."""
    def ent(specs):
        return [(s.out_name, data.units[s.in_name],
                 data.long_name[s.in_name]) for s in specs]

    plan = {}
    if cfg.interp_diag:
        plan["diag2d"] = ent(
            [s for s in routing.diag if data.fields[s.in_name].ndim == 1])
        plan["diag3d"] = ent(
            [s for s in routing.diag if data.fields[s.in_name].ndim == 2])
    if cfg.interp_hist:
        plan["patch2d"] = ent(routing.patch_2d)
        plan["cons2d"] = ent(routing.cons_2d)
        plan["nstd2d"] = ent(routing.nstd_2d)
        plan["soil"] = ent(routing.soil)
        plan["nz3d"] = ent(routing.nz_3d)
        plan["nzp13d"] = ent(routing.nzp1_3d)
        plan["vert3d"] = ent(routing.vert_3d)
        plan["do_u"] = routing.do_u
        plan["do_v"] = routing.do_v
    return plan


def _stack_apply(rg, data: InputData, specs, ndim: int, dtype=np.float32,
                 root_only: bool = False, writer=None, perm=None):
    """One-shot bundle apply (per-field conservative regrids,
    interp_as_bundle=.false.). Returns [(out_name, arr, units, desc)], or
    [] when the result streams to ``writer``."""
    batch = _ApplyBatch(rg, dtype, root_only=root_only, perm=perm)
    res = []
    batch.add_stack(data, specs, ndim, res.extend)
    batch.run(writer=writer)
    return res


def _make_regridder(ell: ELLWeights, dtype, device, mesh=None,
                    precision="highest", source_decomp="replicate",
                    cache_dir=None, perm_inv=None):
    """Pick the apply engine: the tile-packed kernel engine for f32 2-D
    grids, falling back to the plain gather Regridder for f64 runs, 1-D
    targets, or tiles over W_CAP. With ``mesh`` (n_device_shards), the
    operator's target rows are sharded over the ranks; with source_decomp
    "ring"/"allgather" the SOURCE is sharded too and the halo exchanged
    between ranks (the reference's route-handle communication,
    interp.F90:123-134). Without a mesh source_decomp changes nothing, as
    in the JAX package. ``perm_inv``, the renumbering of the source's
    rows into the ELL's, goes to the tile-packed engine, which renumbers
    its uploads; the others take none (``_ApplyBatch``)."""
    if mesh is not None and source_decomp != "replicate":
        return SourceShardedRegridder(ell, mesh, dtype=dtype,
                                      comm=source_decomp)
    if dtype == torch.float32 and len(ell.dst_shape) == 2:
        try:
            return PackedSlabRegridder([ell], device, precision=precision,
                                       cache_dir=cache_dir, mesh=mesh,
                                       perm_inv=perm_inv)
        except ValueError:
            pass
    if mesh is not None:
        return ShardedRegridder(ell, mesh, dtype=dtype)
    return Regridder(ell, device, dtype=dtype)


def _device_mesh(cfg: Config, device):
    """The grid mesh for n_device_shards, or None (0 or 1: no mesh). A
    shard is a rank, one device each: -1 is every rank of the process
    group (a mesh of one without one). More shards than ranks is the JAX
    package's error; fewer than the ranks (but more than one) is refused,
    where the JAX package takes its first n devices."""
    n = cfg.n_device_shards
    if n in (0, 1):
        return None
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    if n == -1:
        n = world
    if n > world:
        raise ValueError(
            f"n_device_shards={n} but only {world} devices present")
    if n < world:
        raise FatalError(
            f"N_DEVICE_SHARDS={n} WITH {world} PROCESSES: THE PORT COUNTS "
            "ONE DEVICE PER RANK AND NEEDS N_DEVICE_SHARDS = -1 OR THE "
            "WORLD SIZE")
    return make_grid_mesh(device)


@dataclasses.dataclass
class PipelineArtifacts:
    """Intermediate state, exposed for tests/benchmarks. ``mesh`` and
    ``data`` are in the input file's cell order. The weights are built
    on the cells renumbered (``renumbered_cells``), and the tile-packed
    ``regridders`` over the cells take their sources in file order; an
    engine that cannot renumber (``_make_regridder``'s others) takes
    them renumbered."""

    cfg: Config
    grid: TargetGrid
    mesh: MPASMesh
    routing: Routing
    data: InputData
    result: RegridResult
    regridders: dict
    timings: Timings


#: the methods whose source is the mesh's cells
CELL_KEYS = ("bilinear", "nearest", "conserve")


def renumbered_cells(cfg: Config, mesh: MPASMesh,
                     grid: TargetGrid) -> ReorderedMesh | None:
    """cell_order = "morton": the mesh's cells renumbered along a Z-curve
    over the target's index space (in latitude bands on a target with no
    projection), so that each target tile's slab gather reads a compact
    span of source rows; the weights are built on it. None for "none"."""
    if cfg.cell_order != "morton":
        return None
    if grid.proj is not None:
        return reorder_cells_morton(mesh, grid.proj)
    return reorder_cells_by_latitude(mesh)


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
    # depends only on the target grid (mesh_fp kept for a uniform key
    # layout); a periodic grid's under tags of their own
    tag = ".periodic" if grid.periodic else ""
    if routing.do_u:
        out["edge1"] = get("edge1" + tag, lambda: edge1_weights(grid))
    if routing.do_v:
        out["edge2"] = get("edge2" + tag, lambda: edge2_weights(grid))
    return out


def run_pipeline(cfg: Config, device, dtype=None) -> PipelineArtifacts:
    """Run the whole regrid on ``device`` (a torch.device or its name).
    ``dtype`` defaults to the namelist's compute_dtype. With
    MPASSIT_PROFILE set, the run is recorded into a trace there."""
    device = torch.device(device)
    if dtype is None:
        dtype = (torch.float64 if cfg.compute_dtype == "float64"
                 else torch.float32)
    prof_dir = os.environ.get("MPASSIT_PROFILE")
    if not prof_dir:
        return _run_pipeline(cfg, device, dtype)
    return _profiled(prof_dir, device,
                     lambda: _run_pipeline(cfg, device, dtype))


#: numbers the profiled calls of the process, so each has a trace of its own
_TRACE_N = itertools.count(1)


def _profiled(out_dir: str, device, run):
    """``run()`` under torch.profiler (host activity of every thread, plus
    the device's on a CUDA device; no shapes, no stacks), then its Chrome
    trace written to ``out_dir``/trace_<pid>_<n>.json, the n-th profiled
    call of the process (the directory made if missing)."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{os.getpid()}_{next(_TRACE_N)}.json")
    # every thread: the streaming writer's spans are on a thread of its own
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        # one op first: the profiler's per-thread set-up then lands before
        # the first span, not inside it
        torch.empty(0)
        art = run()
    prof.export_chrome_trace(path)
    log.info("- profile trace: %s", path)
    return art


def _run_pipeline(cfg: Config, device, dtype) -> PipelineArtifacts:
    timings = Timings()
    with recording(timings):
        art = _run_stages(cfg, device, dtype, timings)
    log.info("- counts: %s", " ".join(
        f"{k}={v}" for k, v in sorted(timings.counts.items())))
    return art


def _run_stages(cfg: Config, device, dtype,
                timings: Timings) -> PipelineArtifacts:
    def timer(name, sync=True):
        return _Timer(timings, name, device if sync else None)

    with timer("define_target_grid"):
        grid = build_target_grid(cfg)
    with timer("define_input_grid"):
        mesh = mesh_from_file(cfg.grid_file_input_grid)

    # the routing and the input checks: a host-only stage in two parts,
    # before and after the read
    with timer("route_fields", sync=False):
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

    with timer("route_fields", sync=False):
        # Reference parity: block_decomp_file is validated when provided
        # (model_grid.F90:437); it decomposes nothing here.
        if cfg.block_decomp_file != "NULL":
            from ..parallel.decomp import read_block_decomp_file

            read_block_decomp_file(cfg.block_decomp_file, mesh.ncells)

        # Input/grid dim consistency: a field sized for a different mesh
        # would misindex the weight apply (utils.F90:16-33 fail-fast
        # contract).
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
                    f"FIELD {wname} HAS {warr.shape[0]} CELLS BUT THE MPAS "
                    f"GRID FILE HAS {mesh.ncells}")

    # cell_order='morton': the weights are built on the source cells
    # renumbered (renumbered_cells); vertex-located fields keep their
    # vertex numbering. The cell-located fields stay in file order: an
    # operator over the cells renumbers them on the device as it uploads
    # them, and one that cannot is handed them permuted (_ApplyBatch).
    # Results are unchanged.
    wmesh, perm, perm_inv = mesh, None, None
    if cfg.cell_order == "morton":
        with timer("reorder_cells", sync=False):
            ro = renumbered_cells(cfg, mesh, grid)
        wmesh, perm, perm_inv = ro.mesh, ro.perm, ro.perm_inv
        del ro

    with timer("weight_generation"):
        weights = build_weights(cfg, wmesh, grid, routing)
        # the renumbered mesh (and the search trees the builds cache on
        # it) is the weights' alone: not held through the apply
        del wmesh
        dev_mesh = _device_mesh(cfg, device)
        cell_map = (None if perm_inv is None
                    else torch.as_tensor(perm_inv, device=device))
        rgs = {k: _make_regridder(v, dtype, device, mesh=dev_mesh,
                                  precision=cfg.apply_precision,
                                  source_decomp=cfg.source_decomp,
                                  cache_dir=cfg.weights_cache_dir,
                                  perm_inv=(cell_map if k in CELL_KEYS
                                            else None))
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

        # stream_output: the whole output schema is created now, then
        # every apply below writes its fetched strips into the file. Rank 0
        # holds the file (the rank-0 serial write, write_data.F90:1005-1475);
        # every other rank runs the same program with a NullStreamWriter:
        # it joins each strip's fetch collective and drops the strip, so no
        # rank materializes the whole output
        writer = None
        deferred: dict = {}
        if cfg.stream_output:
            plan = _build_stream_plan(cfg, routing, data)
            if is_primary():
                with timer("write_to_file"):
                    writer = StreamingWriter(
                        cfg.output_file, cfg, grid, data, plan, mesh.nz,
                        mesh.nzp1, mesh.nsoil, mesh.zs).open()
            else:
                writer = NullStreamWriter()
                log.info("- streaming: process %d participates in strip "
                         "fetches and drops them (no full-output buffer)",
                         torch.distributed.get_rank())

        def batch_for(key: str) -> _ApplyBatch:
            if key not in batches:
                batches[key] = _ApplyBatch(rgs[key], np_dtype,
                                           root_only=root_only,
                                           perm=(perm if key in CELL_KEYS
                                                 else None))
            return batches[key]

        # wind mass fields feed the restagger, sharded too: always
        # gathered to every rank
        wind_batch = _ApplyBatch(rgs["bilinear"], np_dtype, root_only=False,
                                 perm=perm)
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
            if writer is not None and cfg.proj_code == PROJ_LC:
                # U10/V10 await the post-apply Q4 rotation: buffered
                # instead of streamed unrotated
                m2 = {s.in_name: s.out_name for s in d2}
                if "u10" in m2 and "v10" in m2:
                    batch_for("bilinear").defer = frozenset(
                        (m2["u10"], m2["v10"]))

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
                    # regridded one at a time (interp.F90:368-416),
                    # streamed when writing as it goes
                    res.cons2d = [
                        one
                        for s in routing.cons_2d
                        for one in _stack_apply(rgs["conserve"], data, [s], 2,
                                                np_dtype,
                                                root_only=root_only,
                                                writer=writer, perm=perm)
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
            if writer is not None:
                writer.put("HGT", 0, np.asarray(grid.hgt, np.float32))

        winds_rotated = _run_batches_packed(batches, rgs, weights,
                                            root_only, device, grid=grid,
                                            writer=writer, deferred=deferred)
        for b in batches.values():
            b.run(writer=writer, deferred=deferred)
        wind_batch.run()

        if cfg.interp_diag:
            # 10-m wind rotation (interp.F90:138-140, wind_dim=2)
            names2 = [s.in_name for s in d2]
            # streamed, the rotation feeds only the file: rank 0 alone (it
            # has no collective; under fetch_root_only the other ranks'
            # deferred buffers were never filled)
            if ("u10" in names2 and "v10" in names2
                    and cfg.proj_code == PROJ_LC
                    and (writer is None or is_primary())):
                iu, iv = names2.index("u10"), names2.index("v10")
                uo, vo = d2[iu].out_name, d2[iv].out_name
                # streamed: the deferred (ny, nx, 1) buffers
                u, v = ((deferred[uo][0][:, :, 0], deferred[vo][0][:, :, 0])
                        if writer is not None
                        else (res.diag2d[iu][1], res.diag2d[iv][1]))
                u, v = rotate_winds(torch.as_tensor(u, device=device),
                                    torch.as_tensor(v, device=device),
                                    on_device(grid.cosa), on_device(grid.sina))
                u, v = u.cpu().numpy(), v.cpu().numpy()
                if writer is not None:
                    writer.put(uo, 0, u.astype(np.float32))
                    writer.put(vo, 0, v.astype(np.float32))
                else:
                    for i, a in ((iu, u), (iv, v)):
                        res.diag2d[i] = (res.diag2d[i][:1] + (a,)
                                         + res.diag2d[i][2:])

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
            # interp.F90:295-328) through the same apply engines; streamed
            # strip by strip when writing as it goes. A periodic grid's V
            # operator reads the pole rows after the mass points
            def restagger(key, var, mass):
                with span("restagger"):
                    m = mass.reshape(grid.n_points, -1)
                    if weights[key].n_src > grid.n_points:
                        m = with_pole_rows(m, grid.ny, grid.nx)
                    n = wrapped_points(grid, var)
                    if n:
                        count("restagger.wrapped_points", n)
                    if writer is None:
                        return rgs[key].apply_np(m, root_only=root_only)
                    batch = _ApplyBatch(rgs[key], np_dtype,
                                        root_only=root_only)
                    batch.add(m, None, stream=[(var, m.shape[1])])
                    batch.run(writer=writer)
                    return None

            if routing.do_u:
                res.u = restagger("edge1", "U", umass)
            if routing.do_v:
                res.v = restagger("edge2", "V", vmass)
        res.zs = mesh.zs

    if writer is not None:
        # what the run waits for here: the writer thread's last blocks
        # (its blocks are write.block spans of that thread; the schema's
        # open is charged to write_to_file too)
        with timer("write_to_file", sync=False), span("write.finish"):
            writer.finish()

    # test hook: dump the full-precision regrid results before the f32
    # NetCDF write (the file caps agreement at f32 rounding); a streamed
    # run dumps what it held (the mass winds' restagger outputs are not
    # among them) on every rank, an in-memory one on rank 0
    dump = os.environ.get("MPASSIT_DUMP_RESULT")
    if dump and (writer is not None or is_primary()):
        arrs = {}
        for cat in ("diag2d", "diag3d", "patch2d", "nz3d", "nzp13d",
                    "vert3d", "cons2d", "nstd2d", "soil"):
            for name, arr, *_ in getattr(res, cat, None) or []:
                arrs[f"{cat}.{name}"] = arr
        for name in ("u", "v", "hgt"):
            if getattr(res, name, None) is not None:
                arrs[name] = getattr(res, name)
        np.savez(dump, **arrs)

    if writer is None and is_primary():
        with timer("write_to_file"):
            write_output(cfg.output_file, cfg, grid, data, res)

    return PipelineArtifacts(cfg=cfg, grid=grid, mesh=mesh, routing=routing,
                             data=data, result=res, regridders=rgs,
                             timings=timings)


def resolve_device(platform: str) -> torch.device:
    """MPASSIT_PLATFORM value -> torch.device. ``cuda`` requires a CUDA
    device and never falls back to the CPU; on a multi-process launch it
    is the process's own device (``cuda:LOCAL_RANK``)."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise FatalError(
                "MPASSIT_PLATFORM=cuda BUT NO CUDA DEVICE IS AVAILABLE "
                "(set MPASSIT_PLATFORM=cpu to run on the CPU)")
        return torch.device("cuda", local_device_index())
    raise FatalError(
        f"MPASSIT_PLATFORM={platform!r}: EXPECTED 'cuda' OR 'cpu'")


def main(argv=None) -> int:
    import sys

    argv = sys.argv[1:] if argv is None else argv
    nml = argv[0] if argv else "./fort.41"  # mpassit.F90:52-65 default
    # a process group this call starts is destroyed when it returns
    owned = not torch.distributed.is_initialized()
    try:
        # the device first: the backend follows it (NCCL or gloo)
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
        maybe_init_distributed(device)
        run_pipeline(cfg, device)
    except FatalError as e:
        # error_handler/netcdf_err banner + abort (utils.F90:16-58); exit
        # code 999 truncates to 231 like mpi_abort's shell status
        print(e.banner(), file=sys.stderr)
        return 999 & 0xFF
    finally:
        if owned:
            shutdown_distributed()
    log.info("- DONE.")
    return 0
