"""METIS block-decomposition file compatibility.

The reference optionally reads a METIS graph-partition file whose line k
holds the owning MPI rank of cell k (``read_block_decomp_file``,
model_grid.F90:2367-2426), and aborts when the partition count differs from
the MPI size (:2418-2421). Device sharding makes the file unnecessary
(SURVEY §2.2), but we parse it for drop-in compatibility and expose the
partition as a source-sharding hint plus the reference's own validation.
"""

from __future__ import annotations

import numpy as np


def read_block_decomp_file(path: str, ncells: int,
                           n_parts: int | None = None) -> np.ndarray:
    """Returns owner (ncells,) int32. Mirrors the reference's checks:
    line count must equal ncells; if n_parts is given, the partition count
    must match (model_grid.F90:2401,2418-2421)."""
    owners = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            owners.append(int(line.split()[0]))
    if len(owners) != ncells:
        raise ValueError(
            "BLOCK DECOMPOSITION FILE CONTAINS MORE CELLS THAN INPUT GRID"
            if len(owners) > ncells else
            "BLOCK DECOMPOSITION FILE CONTAINS FEWER CELLS THAN INPUT GRID")
    owner = np.asarray(owners, dtype=np.int32)
    if n_parts is not None and owner.max() + 1 != n_parts:
        raise ValueError(
            f"BLOCK DECOMPOSITION FILE GENERATED FOR {owner.max() + 1} "
            f"PROCESSES BUT {n_parts} PROCESSORS USED.")
    return owner


def para_range(n1: int, n2: int, nprocs: int, irank: int) -> tuple[int, int]:
    """The reference's contiguous block split (model_grid.F90:2428-2441):
    1-based inclusive [ista, iend] for rank irank."""
    iwork1 = (n2 - n1 + 1) // nprocs
    iwork2 = (n2 - n1 + 1) % nprocs
    ista = irank * iwork1 + n1 + min(irank, iwork2)
    iend = ista + iwork1 - 1
    if iwork2 > irank:
        iend += 1
    return ista, iend


def partition_order(owner: np.ndarray) -> np.ndarray:
    """Permutation grouping cells by owner (stable) — turns a METIS
    partition into a contiguous renumbering usable as a sharding layout."""
    return np.argsort(owner, kind="stable")
