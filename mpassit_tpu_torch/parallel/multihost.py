"""Process runtime: single process only (counterpart of
mpassit_tpu/parallel/multihost.py).

The JAX package initializes ``jax.distributed`` from
``MPASSIT_COORDINATOR`` / ``MPASSIT_NUM_PROCESSES`` / ``MPASSIT_PROCESS_ID``.
The port runs one process on one device; a multi-process launch raises
instead of silently running every rank as a full single-process job.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_ENV_COORD = "MPASSIT_COORDINATOR"
_ENV_NPROC = "MPASSIT_NUM_PROCESSES"


def maybe_init_distributed() -> bool:
    """Returns False on a single process; raises NotImplementedError when
    the multi-process environment variables are set."""
    if os.environ.get(_ENV_COORD) is None and os.environ.get(_ENV_NPROC) is None:
        return False
    raise NotImplementedError(
        f"{_ENV_COORD}/{_ENV_NPROC} are set, but multi-process runs are not "
        "ported to mpassit_tpu_torch yet (ROADMAP.md queue 1, item 7)")


def is_primary() -> bool:
    """True on the process that owns the output write (always, here)."""
    return True


def fetch_to_host(x, root_only: bool = False, out=None):
    """Device tensor -> host numpy array (the ESMF_FieldGather analog,
    write_data.F90:1006). ``root_only`` changes nothing on one process.
    With ``out`` (a host array of x's shape, a view or not) the transfer
    lands there, without a host array of its own, and ``out`` is
    returned."""
    if out is not None:
        torch.from_numpy(out).copy_(torch.as_tensor(x))
        return out
    if isinstance(x, np.ndarray):
        return x
    return x.cpu().numpy()
