"""Multi-device execution: the regrid sharded over the ranks of a process
group (counterpart of mpassit_tpu/parallel/sharding.py).

A shard is a rank. Each process owns one device, and the 1-D 'grid' mesh
is its process group (``GridMesh``): what the JAX package does through
``shard_map``, ``NamedSharding`` and ``process_allgather``, the port does
through explicit ``torch.distributed`` collectives on the rank's own band
of rows. It replaces the reference's MPI/ESMF parallelism (SURVEY §2.2):

- the source-mesh decomposition (``para_range``/METIS
  ``block_decomp_file``, model_grid.F90:423-437) and the target-grid ESMF
  decomposition (model_grid.F90:687-703) become bands of the ELL
  operator's target rows, one per rank (zero-padded to a multiple of the
  world size: padding rows have w=0 and compute zeros);
- ``ShardedRegridder``: the source replicated on every rank (the
  reference reads the full input on every rank, input_data.F90:191-196),
  so the apply needs no collective; only the result is gathered;
- ``SourceShardedRegridder``: the SOURCE rows sharded too, the halo
  exchanged at apply time (the route-handle communication,
  interp.F90:123-134): ``comm="ring"`` passes each rank's source block
  round the ring (``batch_isend_irecv`` to the left and right neighbours;
  one source block per device at a time), ``comm="allgather"`` assembles
  the whole source first (one collective instead of world - 1);
- ``ring_apply`` and ``shard_map_apply``: their one-shot forms.

The bodies are plain torch operations, as in the JAX package (no Pallas
there either): the K-unrolled ``index_select`` sum of ops/apply.apply_ell
over CB-column chunks. The JAX bodies gather a (rows, K, C) block that XLA
fuses away; torch would materialize it (about 21 GB at CONUS width with
919 columns). Every rank of the mesh must make the same calls in the same
order: the applies' collectives are matched by order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops.apply import apply_ell
from ..weights.ell import ELLWeights
from .multihost import fetch_to_host, gather_bands


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """This process's place in the 1-D grid mesh: its rank and the world
    size of ``group``, and its device. ``group`` None is a mesh of one in
    a process without a process group (no collective runs)."""

    rank: int
    world: int
    device: torch.device
    group: object = None


def make_grid_mesh(device, group=None) -> GridMesh:
    """The mesh of ``group`` (the default group when None) on ``device``;
    a mesh of one when no process group is initialized."""
    device = torch.device(device)
    if not dist.is_initialized():
        return GridMesh(0, 1, device)
    group = group if group is not None else dist.group.WORLD
    return GridMesh(dist.get_rank(group), dist.get_world_size(group), device,
                    group)


def band_rows(a: np.ndarray, mesh: GridMesh, n: int = None) -> np.ndarray:
    """This rank's band of ``a``: rows [rank * n, (rank + 1) * n), zero
    past the data; n defaults to ceil(rows / world)."""
    n = -(-a.shape[0] // mesh.world) if n is None else n
    blk = a[mesh.rank * n:(mesh.rank + 1) * n]
    if blk.shape[0] == n:
        return blk
    return np.concatenate([blk, np.zeros((n - blk.shape[0],) + a.shape[1:],
                                         a.dtype)], axis=0)


class _RowSharded:
    """What both sharded regridders share: the operator's target rows
    banded over the mesh, and the host apply in CB-column chunks, each
    chunk's band gathered to the host (to every rank, or to rank 0 with
    root_only; the others return a zero broadcast view). A subclass
    defines ``_local``: (rows of ``_source``, cb) device source -> (band
    rows, cb)."""

    CB = 256

    def __init__(self, ell: ELLWeights, mesh: GridMesh, dtype=torch.float32):
        self.mesh, self.dtype = mesh, dtype
        self.dst_shape = tuple(ell.dst_shape)
        self.n_dst = ell.idx.shape[0]
        self.n_src = ell.n_src
        self.idx = torch.as_tensor(
            band_rows(np.asarray(ell.idx, np.int64), mesh), device=mesh.device)
        self.w = torch.as_tensor(band_rows(np.asarray(ell.w), mesh),
                                 dtype=dtype, device=mesh.device)

    def _source(self, src):
        """(n_src, C) host source -> what ``_local`` reads, on the host."""
        return src

    def apply_np(self, src, root_only: bool = False):
        """(n_src,) or (n_src, C) host source -> (dst_shape) or
        (dst_shape, C) host result."""
        src = np.asarray(src)
        if src.shape[0] != self.n_src:
            raise ValueError(f"source has {src.shape[0]} rows, operator "
                             f"expects {self.n_src}")
        squeeze = src.ndim == 1
        s2 = self._source(src[:, None] if squeeze else src)
        C = s2.shape[1]
        shape = self.dst_shape + (() if squeeze else (C,))
        np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        out = None
        if not root_only or self.mesh.rank == 0:
            out = np.empty((self.n_dst, C), np_dtype)
        for lo in range(0, C, self.CB):
            hi = min(lo + self.CB, C)
            s = torch.as_tensor(np.ascontiguousarray(s2[:, lo:hi]),
                                dtype=self.dtype, device=self.mesh.device)
            full = fetch_to_host(self._local(s), root_only=root_only,
                                 mesh=self.mesh)
            if out is not None:
                out[:, lo:hi] = full[:self.n_dst]
        if out is None:                # not rank 0, root_only
            return np.broadcast_to(np.zeros((), np_dtype), shape)
        return out.reshape(shape)


class ShardedRegridder(_RowSharded):
    """ELL apply with the target rows sharded over the mesh and the source
    replicated: each rank applies its band of rows (ops/apply.apply_ell),
    with no collective; the result is gathered to the host."""

    def _local(self, src_dev):
        return apply_ell(self.idx, self.w, src_dev)


class SourceShardedRegridder(_RowSharded):
    """ELL apply with BOTH the source rows and the target rows sharded over
    the mesh: each rank uploads only its block of ceil(n_src / world)
    source rows, and the halo is exchanged at apply time.

    comm="ring": the blocks pass round the ring, world - 1 exchanges, each
    rank adding the masked partial apply of the block it holds (one source
    block per device). comm="allgather": the full source assembled by one
    all-gather, then one local apply (faster when the source fits)."""

    def __init__(self, ell: ELLWeights, mesh: GridMesh, dtype=torch.float32,
                 comm: str = "ring"):
        if comm not in ("ring", "allgather"):
            raise ValueError(f"unknown comm {comm!r}")
        super().__init__(ell, mesh, dtype)
        self.comm = comm
        #: source rows per rank
        self.blk = -(-self.n_src // mesh.world)

    def _source(self, src):
        return band_rows(src, self.mesh)

    def _local(self, src_dev):
        if self.comm == "allgather":
            return apply_ell(self.idx, self.w,
                             gather_bands(src_dev, self.mesh))
        return self._ring(src_dev)

    def _ring(self, blk_data):
        """Step s: the block held came from rank (rank + s) % world; add
        its masked partial apply, then pass it to the left neighbour and
        take the right one's."""
        m = self.mesh
        out = None
        for s in range(m.world):
            owner = (m.rank + s) % m.world
            loc = self.idx - owner * self.blk
            in_blk = (loc >= 0) & (loc < self.blk)
            part = apply_ell(loc.clamp(0, self.blk - 1),
                             torch.where(in_blk, self.w, 0), blk_data)
            out = part if out is None else out + part
            if s < m.world - 1:
                nxt = torch.empty_like(blk_data)
                left, right = (dist.get_global_rank(m.group, (m.rank + d)
                                                    % m.world)
                               for d in (-1, 1))
                for req in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, blk_data, left, m.group),
                        dist.P2POp(dist.irecv, nxt, right, m.group)]):
                    req.wait()
                blk_data = nxt
        return out


def _flat(ell: ELLWeights, res):
    """A regridder's (dst_shape[, C]) result -> (n_dst[, C])."""
    return res.reshape((ell.idx.shape[0],) + res.shape[len(ell.dst_shape):])


def ring_apply(ell: ELLWeights, mesh: GridMesh, src, dtype=torch.float32):
    """Source-sharded apply with the ring exchange (see
    SourceShardedRegridder): (n_src[, C]) host source -> (n_dst[, C]) host
    result on every rank."""
    return _flat(ell, SourceShardedRegridder(ell, mesh, dtype=dtype,
                                             comm="ring").apply_np(src))


def shard_map_apply(ell: ELLWeights, mesh: GridMesh, src,
                    dtype=torch.float32):
    """Source-sharded apply with the all-gather halo (see
    SourceShardedRegridder): (n_src[, C]) host source -> (n_dst[, C]) host
    result on every rank."""
    return _flat(ell, SourceShardedRegridder(ell, mesh, dtype=dtype,
                                             comm="allgather").apply_np(src))
