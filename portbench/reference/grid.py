"""The reference's target grid, chosen by the namelist's
``target_grid_type``.

The grid of a kind is worked out by ``targets/<name>.py``, the name the
kind in lower case without its hyphens (``lambert`` -> ``lambert.py``,
``lat-lon`` -> ``latlon.py``), loaded by its path as ``spec.reader`` loads
a metric's reader: a projection is added by adding its file. Its
``grid(nml)`` gives an object with

- ``nx``, ``ny``: the mass points west-east and south-north;
- ``mass``, ``u``, ``v``, ``corner``: (lat, lon) in degrees of 0-based
  ``(j, i)`` on each stagger (U ``(ny, nx + 1)``, V ``(ny + 1, nx)``,
  corners ``(ny + 1, nx + 1)``);
- ``mapfac(lat)``: the map factor, on every stagger;
- ``rotates``: whether MPASSIT turns the winds to grid-relative and writes
  SINALPHA/COSALPHA on this grid, and then ``rotation(j, i)``, (cos alpha,
  sin alpha) at mass points;
- ``periodic``: whether column ``nx - 1`` joins column 0 (a global grid);
- ``cache_key(cache)``: the key under which the reference keeps its cache
  ``cache`` of the grid: for "bilinear" a tuple, for "overlaps" a string.
"""

from __future__ import annotations

import importlib.util
import os

TARGETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "targets")


def module(kind: str):
    """The module of ``targets/`` that works out grids of ``kind``."""
    name = kind.strip().lower().replace("-", "")
    if not name.isidentifier():
        raise ValueError(f"target_grid_type {kind!r} names no file of "
                         f"{TARGETS}")
    path = os.path.join(TARGETS, name + ".py")
    if not os.path.exists(path):
        raise ValueError(f"no reference grid for target_grid_type {kind!r}: "
                         f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        "portbench_target_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def target_grid(nml: dict):
    return module(nml["target_grid_type"]).grid(nml)


Lambert = module("lambert").Lambert
