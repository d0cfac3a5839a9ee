"""Nearest source-to-destination weights (ESMF_REGRIDMETHOD_NEAREST_STOD).

Used by the reference for integer/categorical fields
(ivgtyp/isltyp/xland/landmask, input_data.F90:841; interp.F90:418-434) and —
by quirk Q3 — for the soil bundle (interp.F90:436-447).
"""

from __future__ import annotations

import numpy as np

from ..mesh.mpas import MPASMesh, lonlat_to_xyz
from .ell import ELLWeights


def nearest_weights(mesh: MPASMesh, lat, lon) -> ELLWeights:
    """K=1 operator: each target point takes its nearest cell center
    (chord distance on the unit sphere == great-circle argmin)."""
    lat = np.asarray(lat, dtype=np.float64)
    dst_shape = lat.shape
    p = lonlat_to_xyz(np.asarray(lon).reshape(-1), lat.reshape(-1))
    _, nearest = mesh.cell_tree.query(p, workers=-1)
    idx = nearest.astype(np.int32).reshape(-1, 1)
    w = np.ones((idx.shape[0], 1), dtype=np.float64)
    return ELLWeights(idx=idx, w=w, n_src=mesh.ncells, method="nearest",
                      dst_shape=dst_shape, src_loc="element")
