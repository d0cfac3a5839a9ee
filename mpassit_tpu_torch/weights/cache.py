"""On-disk weight cache keyed by (mesh, grid, method).

The analog of persisting an ESMF route handle — the big rerun win the
reference lacks (SURVEY §5, checkpoint/resume row): weight generation is the
dominant setup cost (the RegridStore search, SURVEY §3.5), and MPASSIT runs
once per forecast hour on the SAME mesh/grid pair.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from ..spans import count, span
from .ell import ELLWeights


def grid_fingerprint(target_grid) -> str:
    h = hashlib.sha256()
    for a in (target_grid.lat, target_grid.lon, target_grid.lat_corner,
              target_grid.lon_corner):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


class WeightCache:
    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _path(self, mesh_fp: str, grid_fp: str, tag: str) -> str:
        """Legacy single-file (.npz) entry path — still honored on read."""
        return os.path.join(self.dir, f"w_{mesh_fp}_{grid_fp}_{tag}.npz")

    def _dir(self, mesh_fp: str, grid_fp: str, tag: str) -> str:
        return os.path.join(self.dir, f"w_{mesh_fp}_{grid_fp}_{tag}")

    def has(self, tag: str, mesh_fp: str, grid_fp: str) -> bool:
        return bool(self.dir) and (
            os.path.exists(os.path.join(self._dir(mesh_fp, grid_fp, tag),
                                        "meta.json"))
            or os.path.exists(self._path(mesh_fp, grid_fp, tag)))

    def get_or_build(self, tag: str, mesh_fp: str, grid_fp: str, builder):
        """Return cached ELLWeights for (mesh, grid, tag) or build + store.

        Entries are directory-of-.npy (mmap-loaded: a warm start touches
        bytes lazily instead of paying a zip CRC sweep + copy); legacy
        .npz entries from older rounds still load. Counts a load as
        ``weights.cache_hits``, a build (a miss, or no cache) as
        ``weights.cache_misses``; each build is a ``weights.build``
        span."""
        if not self.dir:
            return self._build(builder)
        from ..diskcache import load_arrays, save_arrays

        d = self._dir(mesh_fp, grid_fp, tag)
        hit = load_arrays(d)
        if hit is not None:
            try:
                meta, arrs = hit
                ell = ELLWeights(
                    idx=arrs["idx"], w=arrs["w"], n_src=int(meta["n_src"]),
                    method=str(meta["method"]),
                    dst_shape=tuple(meta["dst_shape"]),
                    src_loc=str(meta["src_loc"]))
                count("weights.cache_hits", 1)
                return ell
            except KeyError:
                pass  # incomplete entry: rebuild
        legacy = self._path(mesh_fp, grid_fp, tag)
        if os.path.exists(legacy):
            try:
                ell = ELLWeights.load(legacy)
                count("weights.cache_hits", 1)
                return ell
            except Exception:
                pass  # corrupt cache entry: rebuild
        ell = self._build(builder)
        save_arrays(d, {"n_src": int(ell.n_src), "method": ell.method,
                        "dst_shape": list(ell.dst_shape),
                        "src_loc": ell.src_loc},
                    {"idx": ell.idx, "w": ell.w})
        return ell

    @staticmethod
    def _build(builder):
        count("weights.cache_misses", 1)
        with span("weights.build"):
            return builder()
