"""Helpers of the benchmark's tests: a whole run of the harness at the
test size of ``data/tiny_lambert.json`` (or of its lat-lon variants), on
the CPU (where the program runs its kernels' plain versions) unless a
device is given."""

from __future__ import annotations

import os

import torch

from portbench import check, run, spec

HERE = os.path.dirname(os.path.abspath(__file__))
TINY = os.path.join(HERE, "data", "tiny_lambert.json")


def tiny_config() -> dict:
    return spec.load_json(TINY)


#: the namelists of lat-lon targets at the test size: MPASSIT's global
#: mode at 4 degrees (90 x 45 mass points) and a regional grid
LATLON = {
    "global": {"target_grid_type": "lat-lon", "is_regional": False,
               "nx": 91, "ny": 46, "stand_lon": 0.0},
    "regional": {"target_grid_type": "lat-lon", "nx": 41, "ny": 31,
                 "dx": 1.5, "dy": 1.2, "ref_lat": 35.0, "ref_lon": -100.0},
}


def latlon_config(kind: str) -> dict:
    """The test configuration with the lat-lon target ``kind`` in place of
    its Lambert one."""
    cfg = tiny_config()
    nml = {k: v for k, v in cfg["namelist"].items()
           if k in ("interp_diag", "interp_hist", "wrf_mod_vars",
                    "esmf_log")}
    return dict(cfg, name="tiny_latlon_" + kind,
                namelist=dict(nml, **LATLON[kind]))


def tiny_run(tmp, mix=None, seconds=0.3, trace=False, device="cpu",
             seed=2**33 + 17, cfg=None):
    """Set-up, window and check of one run at the test size; returns
    (the Run, its compared numbers). The Run's inputs are deleted."""
    mix = mix or spec.traffic("hourly_cached")
    r = run.Run("tiny", cfg or tiny_config(), mix, seed, seconds, trace,
                torch.device(device), os.path.join(str(tmp), "cache"))
    try:
        r.setup()
        r.window(0.0)
        numbers = r.judge()
    finally:
        r.close()
    return r, numbers


def passes(numbers) -> bool:
    return check.verdict(numbers)
