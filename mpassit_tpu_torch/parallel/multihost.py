"""Multi-process runtime (counterpart of mpassit_tpu/parallel/multihost.py,
the MPI_Init / ESMF VM replacement, mpassit.F90:71,89-96).

One process drives one device: ``cuda:LOCAL_RANK`` on a CUDA run, the CPU
under ``MPASSIT_PLATFORM=cpu``. The processes meet through
``torch.distributed``, over NCCL on CUDA devices and gloo on the CPU; a
CUDA run that cannot use NCCL is an error, never moved to gloo. A launch is
driven by environment variables, so the same CLI runs on one process or N:

- ``MPASSIT_COORDINATOR``   address of process 0 (``host:port`` or
  ``tcp://host:port``)
- ``MPASSIT_NUM_PROCESSES`` world size
- ``MPASSIT_PROCESS_ID``    this process's rank

or ``MPASSIT_NUM_PROCESSES`` alone under a launcher that sets the
``env://`` variables (torchrun: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``).

After initialization the pipeline's ``n_device_shards=-1`` shards the
applies over every rank (parallel/sharding.py); rank 0 writes the output,
as the reference's rank-0 serial NetCDF write (write_data.F90:1005-1475).
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..errors import FatalError

log = logging.getLogger("mpassit_tpu_torch")

_ENV_COORD = "MPASSIT_COORDINATOR"
_ENV_NPROC = "MPASSIT_NUM_PROCESSES"
_ENV_PID = "MPASSIT_PROCESS_ID"
#: seconds a collective (and the rendezvous) waits for its peers before the
#: run fails: a lost rank ends the job instead of hanging it. Ranks build or
#: load their weights independently before the first collective.
TIMEOUT_S = 1800


def multiprocess_requested() -> bool:
    """True when the environment asks for a multi-process launch."""
    return (os.environ.get(_ENV_COORD) is not None
            or os.environ.get(_ENV_NPROC) is not None)


def _env_int(name: str, lo: int, hi: int | None = None) -> int:
    """The integer in environment variable ``name``, in [lo, hi); a
    FatalError naming the variable when it is missing or out of range."""
    v = os.environ.get(name)
    if v is None:
        raise FatalError(f"{name} IS NOT SET: A MULTI-PROCESS LAUNCH NEEDS "
                         "IT")
    try:
        n = int(v)
    except ValueError:
        n = None
    if n is None or n < lo or (hi is not None and n >= hi):
        rng = f"[{lo}, {hi})" if hi is not None else f">= {lo}"
        raise FatalError(f"{name}={v!r}: EXPECTED AN INTEGER {rng}")
    return n


def launch_spec() -> tuple[int, int, str]:
    """(world size, rank, init method) of a multi-process launch, checked.
    With ``MPASSIT_COORDINATOR`` both ``MPASSIT_NUM_PROCESSES`` and
    ``MPASSIT_PROCESS_ID`` must be set (the rank in [0, world)): torch has
    no launcher to detect them from, and a missing rank would make every
    process rank 0. Without a coordinator the launcher's ``env://``
    variables must be set, with ``WORLD_SIZE`` equal to
    ``MPASSIT_NUM_PROCESSES``."""
    world = _env_int(_ENV_NPROC, 1)
    coord = os.environ.get(_ENV_COORD)
    if coord is not None:
        return (world, _env_int(_ENV_PID, 0, world),
                coord if "://" in coord else f"tcp://{coord}")
    for name in ("MASTER_ADDR", "MASTER_PORT"):
        if os.environ.get(name) is None:
            raise FatalError(f"{_ENV_NPROC} WITHOUT {_ENV_COORD} NEEDS A "
                             f"LAUNCHER'S env:// VARIABLES: {name} IS NOT "
                             "SET")
    if _env_int("WORLD_SIZE", 1) != world:
        raise FatalError(f"WORLD_SIZE={os.environ['WORLD_SIZE']} BUT "
                         f"{_ENV_NPROC}={world}")
    return world, _env_int("RANK", 0, world), "env://"


def local_device_index() -> int:
    """The CUDA device this process owns: ``LOCAL_RANK`` when a launcher
    sets it, else the rank modulo the visible devices on a multi-process
    launch, else the current device."""
    if os.environ.get("LOCAL_RANK") is not None:
        return int(os.environ["LOCAL_RANK"])
    if multiprocess_requested():
        return launch_spec()[1] % torch.cuda.device_count()
    return torch.cuda.current_device()


def maybe_init_distributed(device) -> bool:
    """Initialize the process group when the multi-process variables are
    set: NCCL for a CUDA ``device`` (made the current device first), gloo
    for the CPU. Returns True when a multi-process runtime is up.
    Idempotent; returns False (and does nothing) on a single process."""
    if not multiprocess_requested():
        return False
    device = torch.device(device)
    if not dist.is_initialized():
        world, rank, init_method = launch_spec()
        if device.type == "cuda":
            if not dist.is_nccl_available():
                raise FatalError(
                    "MULTI-PROCESS CUDA RUN NEEDS NCCL, WHICH THIS TORCH "
                    "BUILD LACKS")
            torch.cuda.set_device(device)
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
    log.info("- distributed runtime: process %d of %d, %s on %s",
             dist.get_rank(), dist.get_world_size(), dist.get_backend(),
             device)
    return True


def shutdown_distributed() -> None:
    """Destroy the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that owns the output write (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_bands(x, mesh, root_only: bool = False):
    """Every rank's ``x`` (one shape on each) -> their concatenation along
    dim 0 in rank order, a (world * rows, ...) device tensor: on every
    rank, or with ``root_only`` on the mesh's rank 0 only (None
    elsewhere). Every rank of the mesh must call it. Without a process
    group (a mesh of one, or no mesh) it is ``x`` itself. The device holds
    ``x`` made contiguous and the gathered tensor: (1 + world) times x's
    bytes at most."""
    if mesh is None or mesh.group is None:
        return x
    x = x.contiguous()
    out = None
    if not root_only or mesh.rank == 0:
        out = torch.empty((mesh.world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
    if root_only:
        dist.gather(x, list(out.chunk(mesh.world)) if out is not None
                    else None, dst=dist.get_global_rank(mesh.group, 0),
                    group=mesh.group)
    else:
        dist.all_gather_into_tensor(out, x, group=mesh.group)
    return out


def fetch_to_host(x, root_only: bool = False, mesh=None):
    """Device tensor -> host numpy array (the ESMF_FieldGather analog,
    write_data.F90:1006).

    Under a ``mesh`` with a process group, ``x`` is this rank's band of
    rows of a row-sharded result, and the result is the concatenation of
    every rank's band along dim 0 (gather_bands): on every rank, or with
    ``root_only`` on rank 0 only, where every other rank gets None (it
    still joins the collective). Use root_only only for terminal fields:
    a root-only result must never feed a later sharded apply."""
    full = gather_bands(x, mesh, root_only)
    return None if full is None else full.cpu().numpy()
