"""Earth-relative -> grid-relative wind rotation for Lambert grids.

Counterpart of ``mpassit_tpu/ops/rotate.py`` (the reference's
``rotate_winds_cgrid``, interp.F90:689-749). Quirk Q4 is kept verbatim:
u is rotated first and v is computed from the ALREADY-ROTATED u::

    tana = sina/cosa
    u' = (u + v*tana) / (cosa + sina*tana)
    v' = (v - u'*sina) / cosa          # <- u', not u

The divisions amplify f32 rounding by ~1/cosa^2 as |alpha| -> 90 deg and
divide by zero at cosa == 0, as the reference does (register R11);
``check_rotation_angles`` warns on the host before such a grid is rotated.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger("mpassit_tpu_torch")

#: |cosa| below this (|alpha| > ~84 deg) warns: the Q4 divisions amplify
#: f32 rounding by ~1/cosa^2 (register R11)
COSA_WARN = 0.1


def check_rotation_angles(cosa, name="target grid") -> float:
    """Host-side degeneracy guard for the Q4 rotation: returns min |cosa|
    and warns when any grid point's rotation angle approaches 90 deg."""
    m = float(np.abs(np.asarray(cosa)).min())
    if m < COSA_WARN:
        log.warning(
            "- WARNING: %s rotation angles reach |cosa|=%.3g "
            "(|alpha| > %.1f deg); the Q4 wind-rotation divisions amplify "
            "f32 rounding by ~1/cosa^2 there (parity register R11)",
            name, m, float(np.degrees(np.arccos(min(m, 1.0)))))
    return m


def rotate_winds(u, v, cosa, sina):
    """u, v: (ny, nx) or (ny, nx, nz) tensors; cosa/sina: (ny, nx) on the
    same device. Returns (u_rot, v_rot) in the reference's sequential
    update order."""
    if u.dim() == 3:
        cosa = cosa[:, :, None]
        sina = sina[:, :, None]
    tana = sina / cosa
    u_new = (u + v * tana) / (cosa + sina * tana)
    v_new = (v - u_new * sina) / cosa
    return u_new, v_new
